"""LM training in the PyTorch port against ``repro`` on the CPU: the
``train`` kind of ``build_lm_bundle`` (``grad_accum``, remat, AdamW and
Adafactor), ``launch/train.py``'s LM branch, the runner on an LM state,
and bf16 leaves across the host boundary and through checkpoints.

The anchor is ``repro``'s own train step, ``jax.jit(build_bundle(spec,
"train_4k", mesh, {"grad_accum": a}).fn)`` with no ``in_shardings``
(its jitted bundle fails under the mesh shardings: the reference
failures of ``test_arch_smoke.py``). Both packages start from one state
as numpy: the port's ``init_state`` (parameters drawn in the spec's
``param_dtype`` from seed 0, ``bq bk bv`` redrawn non-zero with numpy,
the optimizer's zeros), read by ``snapshot`` and carried to the port by
``checkpoint.state_from_tree`` and to ``repro`` as arrays (bf16 leaves
viewed as ``ml_dtypes.bfloat16``); ``repro``'s eager ``init_lm`` would
compile op by op. Both take the launcher's batches (``make_batch_fn``)
at the smoke shape (4 sequences of 64 tokens). One jit a case, each case
run once a module.

Both packages take the schedule's warm-up as 1 step (the ``warmup``
override): step 0's learning rate is 0 and every later step updates at
the full rate (AdamW 3e-4, Adafactor 1e-2), so the parameters move by
~3e-4 (AdamW) and ~1e-2 (Adafactor) a step and the optimizer's update is
compared, not only its input. Tolerances are ``tests/test_torch_lm.py``'s:
``FP32`` (rtol and atol 1e-5) at ``LMConfig(dtype="float32")`` for every
leaf, loss and gnorm, ``BF16`` (``repro``'s 5e-2) for kimi-k2, whose
parameters are bf16 and train with Adafactor. On top of those, each leaf
is held at its own scale. In fp32 a parameter is within ``PARAM_ULPS``
fp32 ulps of the leaf's max |p| (what remains is the rounding of
p - lr·u, 1 ulp on a CPU, over an update of ~10^4 ulps), and each
optimizer moment within ``MOMENT_REL`` of its leaf's max |·| on
``repro``'s side (2e-6 at most on a CPU); the first moments
(``opt/mu``) also to atol 1e-7. kimi-k2's gradients are bf16 products,
and Adafactor divides each by its running RMS, so a bf16 rounding
difference in a small gradient becomes an O(1) difference in its update:
its parameters' change p_t - p0 and its moments are held to
``KIMI_REL`` in relative Frobenius norm (0.24 at most on a CPU; a
dropped update reads 1, a sign-flipped one 2), and the update itself,
on the same gradients in both packages, to half a bf16 ulp a step in
``test_optimizer_update_matches_repro``. ``repro``'s Adafactor turns
bf16 parameters into fp32 after a step (its fp32 learning rate promotes
them); the port keeps bf16, so kimi's parameters are compared as
values. The MoE routing of every call is bitwise, on the port's hidden
states with each package's router weights.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.configs import registry as j_registry
from repro.launch import train as j_train
from repro.train.steps import build_bundle as j_build_bundle
from repro.train.steps import make_optimizer as j_make_optimizer
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.core import sync
from repro_torch.configs import registry as t_registry
from repro_torch.fault import FaultTolerantRunner, RunnerConfig
from repro_torch.launch import train as t_train
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.train.steps import build_bundle as t_build_bundle
from repro_torch.train.steps import make_optimizer as t_make_optimizer
from repro_torch.tree import flatten_with_paths, leaves, tree_map, \
    unflatten_paths

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
MU_ATOL = 1e-7
PARAM_ULPS = 4      # fp32 parameters: ulps of the leaf's max |p|
MOMENT_REL = 1e-5   # fp32 moments: max |d| / the leaf's max |repro|
KIMI_REL = 0.4      # kimi-k2: |d|_F / |repro|_F of p_t - p0 and moments
WARMUP = 1          # the schedule's warm-up: full-rate updates from step 1
# (arch, grad_accum, compute dtype, steps)
CASES = [("granite-8b", 1, "float32", 3), ("granite-8b", 2, "float32", 3),
         ("qwen2-moe-a2.7b", 1, "float32", 3),
         ("qwen2-moe-a2.7b", 2, "float32", 3),
         ("kimi-k2-1t-a32b", 2, "bfloat16", 3),
         ("yi-34b", 1, "float32", 2), ("qwen2-72b", 1, "float32", 2)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny steps on one intra-op thread (restored after the
    module): at these sizes more threads only contend with the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(case):
    arch, accum, dtype, _ = case
    return f"{arch}-a{accum}-{dtype}"


def _specs(arch, dtype):
    """``repro``'s and the port's smoke specs with the model in
    ``dtype``."""
    out = []
    for registry, train in ((j_registry, j_train), (t_registry, t_train)):
        spec = train.smoke_spec(registry.get_spec(arch))
        out.append(dataclasses.replace(spec, model_cfg=dataclasses.replace(
            spec.model_cfg, dtype=dtype)))
    return out


def _initial_state(tspec):
    """The initial train state as numpy (bf16 leaves as ``V2``): the
    port's ``init_state`` with every ``bq bk bv`` redrawn N(0, 0.5)."""
    r = np.random.default_rng(1)
    state = t_ckpt.snapshot(t_train.init_state(
        tspec, t_build_bundle(tspec, "train_4k", "cpu")))
    flat = {}
    for path, leaf in flatten_with_paths(state):
        if path.startswith("params/") and path.rsplit("/", 1)[-1] in (
                "bq", "bk", "bv"):
            new = (0.5 * r.standard_normal(leaf.shape)).astype(np.float32)
            leaf = new.astype(ml_dtypes.bfloat16).view(leaf.dtype) \
                if sync.is_bf16_host(leaf.dtype) else new
        flat[path] = leaf
    return unflatten_paths(flat.items())


def _as_repro(a):
    """A host array as ``repro`` takes it (bf16 patterns as
    ``ml_dtypes.bfloat16``)."""
    return a.view(ml_dtypes.bfloat16) if sync.is_bf16_host(a.dtype) else a


class RouteRecorder:
    """Records every ``models.moe.route`` call's arguments and result."""

    def __init__(self):
        self.plain, self.calls = t_moe.route, []

    def __enter__(self):
        def recorded(p, cfg, xf, dtype=torch.bfloat16, dist=None):
            r = self.plain(p, cfg, xf, dtype, dist)
            self.calls.append((p["router"].detach().clone(), cfg,
                               xf.detach().clone(), dtype, r))
            return r
        t_moe.route = recorded
        return self

    def __exit__(self, *exc):
        t_moe.route = self.plain


@functools.partial(jax.jit, static_argnums=(1, 3))
def _j_routing(router, cfg, x, dtype):
    """``repro.models.moe.moe_ffn``'s routing lines (moe.py:90-106):
    (top_i, slot, keep)."""
    logits = (x.astype(dtype) @ router.astype(dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_i = jax.lax.top_k(probs, cfg.top_k)
    n, k, t = cfg.n_total, cfg.top_k, x.shape[0]
    cap = int(cfg.capacity_factor * k * t / cfg.n_experts + 1)
    flat_e = top_i.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = jnp.arange(t * k, dtype=jnp.int32)
    first = jax.ops.segment_min(idx, sorted_e, num_segments=n)
    rank = idx - first[sorted_e]
    keep = rank < cap
    return top_i, jnp.where(keep, sorted_e * cap + rank, n * cap), keep


@pytest.fixture(scope="module")
def runs():
    """``case -> run``, each case run once a module (``_run``)."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run(case)
        return cache[case]
    return get


def _run(case):
    """Both packages' trajectories from one state: per step the state
    after it (numpy) and ``(loss, gnorm)``; and the port's routing calls
    beside both packages' stacked routers at the same step."""
    arch, accum, dtype, steps = case
    jspec, tspec = _specs(arch, dtype)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ov = {"grad_accum": accum, "warmup": WARMUP}
    jfn = jax.jit(j_build_bundle(jspec, "train_4k", mesh, ov).fn)
    jbatch = j_train.make_batch_fn(jspec, "train_4k")
    bundle = t_build_bundle(tspec, "train_4k", "cpu", ov)
    tbatch = t_train.make_batch_fn(tspec, "train_4k", device="cpu")
    state0 = _initial_state(tspec)
    js = jax.tree.map(_as_repro, state0)
    ts = t_ckpt.state_from_tree(state0, "cpu")
    out = {"case": case, "state0": state0, "repro": [], "port": [],
           "routes": []}
    for i in range(steps):
        ffn = ts["params"]["blocks"]["ffn"]
        routers = (ffn["router"].clone(), np.asarray(
            js["params"]["blocks"]["ffn"]["router"])) if "router" in ffn \
            else None
        with RouteRecorder() as rec:
            ts, tm = bundle.fn(ts, tbatch(i))
        out["routes"] += [(routers, c) for c in rec.calls]
        js, jm = jfn(js, jbatch(i))
        out["repro"].append((jax.tree.map(np.asarray, js),
                             (float(jm["loss"]), float(jm["gnorm"]))))
        out["port"].append((t_ckpt.snapshot(ts),
                            (float(tm["loss"]), float(tm["gnorm"]))))
    return out


def _values(a):
    """A host array as fp32 (bf16 patterns and ``ml_dtypes`` included)."""
    if sync.is_bf16_host(a.dtype):
        a = a.view(ml_dtypes.bfloat16)
    return np.asarray(a, np.float32)


def _at_scale(what, got, want, p0=None):
    """``got`` against ``want`` at the leaf's own scale: parameters
    (``p0`` given) within ``PARAM_ULPS`` fp32 ulps of max |p|, which the
    update must exceed 100-fold once it runs at the full rate; moments
    within ``MOMENT_REL`` of max |want|."""
    if p0 is not None:
        tol = PARAM_ULPS * np.spacing(np.float32(max(np.abs(want).max(),
                                                     np.abs(p0).max())))
        moved = np.abs(want - p0).max()
        assert moved > 100 * tol, (what, moved, tol)
    else:
        tol = MOMENT_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _frobenius(what, got, want, bound):
    """|got - want|_F within ``bound`` of |want|_F (which is non-zero)."""
    ref = np.linalg.norm(want)
    assert ref > 0, what
    assert np.linalg.norm(got - want) <= bound * ref, (
        what, np.linalg.norm(got - want) / ref)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_train_steps_match_repro(runs, case):
    """Every leaf of the state, loss and gnorm after each step; the step
    count exactly; each leaf also at its own scale (``_at_scale``; kimi-k2:
    ``_frobenius``), the parameters by their change from step 0 once the
    learning rate is non-zero (from step 1); ``opt/mu`` also to atol
    1e-7."""
    arch, accum, dtype, steps = case
    run = runs(case)
    tol = FP32 if dtype == "float32" else BF16
    p0 = {k: _values(v) for k, v in flatten_with_paths(run["state0"])}
    for i, ((jstate, jm), (tstate, tm)) in enumerate(
            zip(run["repro"], run["port"])):
        assert np.isfinite(tm).all(), (i, tm)
        np.testing.assert_allclose(tm, jm, err_msg=f"step {i} loss, gnorm",
                                   **tol)
        jf, tf = dict(flatten_with_paths(jstate)), \
            dict(flatten_with_paths(tstate))
        assert jf.keys() == tf.keys()
        assert int(tf["step"]) == int(jf["step"]) == i + 1
        for k in jf:
            assert tf[k].shape == jf[k].shape, k
            got, want = _values(tf[k]), _values(jf[k])
            assert np.isfinite(got).all(), (i, k)
            if dtype == "float32":
                assert tf[k].dtype == jf[k].dtype, k
            np.testing.assert_allclose(got, want, err_msg=f"step {i} {k}",
                                       **tol)
            what = f"step {i} {k}"
            if k.startswith("params/"):
                if i == 0:      # the warm-up's rate is 0 at step 0
                    assert np.array_equal(got, p0[k]), what
                elif dtype == "float32":
                    _at_scale(what, got, want, p0[k])
                else:
                    _frobenius(what, got - p0[k], want - p0[k], KIMI_REL)
            elif k.startswith("opt/"):
                if dtype == "float32":
                    _at_scale(what, got, want)
                else:
                    _frobenius(what, got, want, KIMI_REL)
            if dtype == "float32" and k.startswith("opt/mu/"):
                np.testing.assert_allclose(tf[k], jf[k], rtol=tol["rtol"],
                                           atol=MU_ATOL,
                                           err_msg=f"step {i} {k}")
    # the port keeps param_dtype; repro's first state held it too
    pdt = "bfloat16" if arch.startswith("kimi") else "float32"
    for state in (run["port"][-1][0], run["state0"]):
        assert {"bfloat16" if sync.is_bf16_host(a.dtype) else str(a.dtype)
                for a in leaves(state["params"])} == {pdt}


def _bf16_ulps(x) -> np.ndarray:
    """The bf16 spacing at |x| (its exponent's ulp; 2^-133 at 0)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("name,pdt,gdt", [
    ("adamw", "float32", "float32"), ("adafactor", "bfloat16", "float32"),
    ("adafactor", "bfloat16", "bfloat16")])
def test_optimizer_update_matches_repro(name, pdt, gdt):
    """``make_optimizer(name, warmup=1)``'s ``update`` in both packages on
    the same seeded gradients (``gdt``: ``grad_accum`` > 1 passes fp32
    sums, 1 passes the parameters' dtype) for 4 steps, each package
    carrying its own state: gnorm; the moments within 1e-6 of their max;
    AdamW's fp32 parameters within 1 fp32 ulp of the leaf's max |p|.
    Adafactor's bf16 parameters against ``repro``'s (fp32 after a step):
    equal at step 0 (rate 0), then the port's rounding to bf16 adds at
    most half an ulp a step, and its bf16 cast of the update 2^-9 of
    lr·|u| (~0.02 ulp at |p| ~ 0.1), so after step s within 0.55·s ulps
    of the largest |p| so far (1.03 at step 3 on a CPU), each update
    being ~10 such ulps. ``repro`` runs jitted on fp32 gradients and
    eagerly on bf16 ones: under jit XLA may keep the clipped bf16
    gradients in fp32 (excess precision)."""
    r = np.random.default_rng(0)
    shapes = {"stack": (2, 6, 8), "b": (8,)}   # factored, and a full v
    bf16 = ml_dtypes.bfloat16
    p0 = {k: (0.1 * r.standard_normal(s)).astype(
        bf16 if pdt == "bfloat16" else np.float32) for k, s in shapes.items()}
    jopt = j_make_optimizer(name, warmup=1)
    topt = t_make_optimizer(name, warmup=1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: sync.upload(v, "cpu") for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update) if gdt == "float32" else jopt.update
    scale = {k: np.abs(_values(v)).max() for k, v in p0.items()}
    for step in range(4):
        g = {k: r.standard_normal(s).astype(bf16 if gdt == "bfloat16"
                                            else np.float32)
             for k, s in shapes.items()}
        jp, js, jn = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp, jnp.int32(step))
        tp, ts, tn = topt.update({k: sync.upload(v, "cpu")
                                  for k, v in g.items()}, ts, tp,
                                 torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        jf = dict(flatten_with_paths(jax.tree.map(np.asarray, js)))
        tf = dict(flatten_with_paths(ts))
        assert jf.keys() == tf.keys()
        for k, want in jf.items():
            np.testing.assert_allclose(tf[k].numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"step {step} opt {k}")
        for k in shapes:
            assert tp[k].dtype == getattr(torch, pdt), k
            got = tp[k].float().numpy()
            want = np.asarray(jp[k], np.float32)
            scale[k] = max(scale[k], np.abs(want).max())
            ulp = np.spacing(np.float32(scale[k])) if pdt == "float32" \
                else _bf16_ulps(scale[k])
            moved = np.abs(want - _values(p0[k])).max()
            assert (moved == 0) if step == 0 else (moved > 5 * ulp), \
                (step, k, moved)
            np.testing.assert_allclose(
                got, want, rtol=0, atol=ulp if pdt == "float32"
                else 0.55 * step * ulp, err_msg=f"step {step} param {k}")


@pytest.mark.parametrize("case", [c for c in CASES if c[0] ==
                                  "qwen2-moe-a2.7b"], ids=_ids)
def test_moe_routing_bitwise(runs, case):
    """Every routing call of the port's fp32 steps (forward and remat
    recompute, each layer and micro-batch): ``top_i``, ``slot`` and
    ``keep`` equal to ``repro``'s routing lines on the same hidden states
    with ``repro``'s router of that layer at that step."""
    arch, accum, dtype, steps = case
    run = runs(case)
    # 2 layers a micro-batch, each routed in the forward and the recompute
    assert len(run["routes"]) == 2 * 2 * accum * steps
    for (tstack, jstack), (trouter, cfg, xf, dt, r) in run["routes"]:
        layer, = [i for i in range(tstack.shape[0])
                  if torch.equal(tstack[i], trouter)]
        top_i, slot, keep = _j_routing(jnp.asarray(jstack[layer]), cfg,
                                       jnp.asarray(xf.numpy()), jnp.float32)
        np.testing.assert_array_equal(r.top_i.numpy(), np.asarray(top_i))
        np.testing.assert_array_equal(r.slot.numpy(), np.asarray(slot))
        np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))


# ------------------------------------------------------------------ remat
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-moe-a2.7b"])
def test_remat_policies_give_bitwise_gradients(arch, batch):
    """``remat_policy`` ``"none"``, ``"dots"`` and ``"off"`` (and
    ``remat=False``) give the same loss and gradients bitwise in fp32 and
    bf16; at batch 1 the score product is a view the "dots" policy keeps
    (it must not be divided in place)."""
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 64, (batch, 17)).astype(np.int32))
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(t_tf.tiny_like(
            t_registry.get_spec(arch).model_cfg), dtype=dtype)
        params = t_tf.init_lm(cfg, 0, "cpu")
        got = {}
        for policy, remat in (("none", True), ("dots", True), ("off", True),
                              ("none", False)):
            c = dataclasses.replace(cfg, remat_policy=policy, remat=remat)
            p = tree_map(lambda a: a.detach().requires_grad_(), params)
            loss = t_tf.lm_loss(p, c, tokens[:, :-1], tokens[:, 1:])
            got[policy, remat] = (loss, torch.autograd.grad(loss, leaves(p)))
        want = got["none", True]
        for key, (loss, grads) in got.items():
            assert torch.equal(loss, want[0]), (dtype, key)
            assert all(torch.equal(a, b) for a, b in zip(grads, want[1])), \
                (dtype, key)
    with pytest.raises(ValueError, match="remat_policy"):
        t_tf.forward(params, dataclasses.replace(cfg, remat_policy="all"),
                     tokens)


def test_train_bundle_overrides():
    """``compress_pods`` without a mesh's ``pod`` axis is ignored, as in
    ``repro`` (the plain step, its state unchanged; the int8 step is
    ``tests/test_torch_distributed.py``'s); a batch that does not split
    into ``grad_accum`` micro-batches raises."""
    _, spec = _specs("granite-8b", "float32")
    plain = t_build_bundle(spec, "train_4k", "cpu")
    ignored = t_build_bundle(spec, "train_4k", "cpu", {"compress_pods": True})
    assert ignored.name == plain.name and not ignored.static_meta["compress"]
    state = t_train.init_state(spec, ignored)
    assert "err" not in state
    batch = t_train.make_batch_fn(spec, "train_4k", device="cpu")(0)
    a, b = ignored.fn(state, batch)[0], plain.fn(state, batch)[0]
    for (k, x), (_, y) in zip(flatten_with_paths(a), flatten_with_paths(b)):
        assert torch.equal(x, y), k
    bundle = t_build_bundle(spec, "train_4k", "cpu", {"grad_accum": 3})
    state = t_train.init_state(spec, bundle)
    with pytest.raises(ValueError, match="3 micro-batches"):
        bundle.fn(state, t_train.make_batch_fn(spec, "train_4k",
                                               device="cpu")(0))


# --------------------------------------------------------- launcher, runner
@pytest.mark.parametrize("arch", ["granite-8b", "kimi-k2-1t-a32b"])
def test_launcher_trains_an_lm(arch, tmp_path, capsys):
    """``launch/train.py --arch <lm> --smoke --steps 3 --device cpu``
    through ``main``, then ``--resume`` to 4 from its checkpoint."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    t_train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert f"[{arch}/train_4k] 3 steps" in out and "done" in out
    t_train.main(argv + ["--steps", "4", "--resume"])
    assert "resumed at step 3" in capsys.readouterr().out


def test_runner_on_a_bf16_lm_state(tmp_path):
    """kimi-k2's smoke state (bf16 parameters, Adafactor) through
    ``FaultTolerantRunner``: checkpoints every 2 steps restore bitwise; a
    resume from step 4 and a run with one injected failure at step 5
    (rolled back to step 4) end bitwise where an uninterrupted 6 steps
    end."""
    spec = t_train.smoke_spec(t_registry.get_spec("kimi-k2-1t-a32b"))
    bundle = t_build_bundle(spec, "train_4k", "cpu")
    state0 = t_train.init_state(spec, bundle)
    assert state0["params"]["embed"].dtype == torch.bfloat16
    make_batch = t_train.make_batch_fn(spec, "train_4k", device="cpu")

    def runner(sub, step_fn=bundle.fn):
        return FaultTolerantRunner(step_fn, state0, make_batch, RunnerConfig(
            str(tmp_path / sub), ckpt_every=2, handle_sigterm=False))

    def same(a, b):
        fa, fb = dict(flatten_with_paths(a)), dict(flatten_with_paths(b))
        assert fa.keys() == fb.keys()
        for k in fa:
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k

    straight = runner("straight")
    straight.run(6)
    fresh = runner("straight")
    assert fresh.restore() == 6
    same(fresh.state, straight.state)
    runner("resume").run(4)
    resumed = runner("resume")
    assert resumed.restore() == 4
    resumed.run(6)
    same(resumed.state, straight.state)
    fired = []

    def failing(state, batch):
        out = bundle.fn(state, batch)
        if flaky.step == 5 and not fired:
            fired.append(5)
            raise RuntimeError("injected fault at step 5")
        return out

    flaky = runner("flaky", failing)
    flaky.run(6)
    assert [(s, k) for s, k, _ in flaky.events] == [(5, "step_failure"),
                                                     (4, "rollback")]
    same(flaky.state, straight.state)


# ------------------------------------------------- bf16 across the host
def test_bf16_host_boundary():
    """A bf16 tensor reads to the host as its raw 2-byte patterns (``V2``)
    through ``host_read`` and ``host_arrays``; ``upload`` takes that form
    and ``ml_dtypes.bfloat16`` arrays (0-d included) back to bf16,
    bitwise."""
    x = torch.randn(3, 5).to(torch.bfloat16)
    bits = x.view(torch.int16).numpy()
    for h in (sync.host_read(x), sync.host_arrays(x, 1.0)[0],
              sync.host_read((x,))[0]):
        assert h.dtype == np.dtype("V2") and h.shape == (3, 5)
        np.testing.assert_array_equal(h.view(np.int16), bits)
    for a in (sync.host_read(x), np.asarray(jnp.asarray(
            x.float().numpy()).astype(jnp.bfloat16)),
              np.asarray(jnp.bfloat16(2.5)), np.zeros((), "V2")):
        t = sync.upload(a, "cpu")
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    assert sync.upload(np.ones(2, np.uint16), "cpu").dtype == torch.uint16


def _kimi_state():
    """kimi-k2's smoke train state on the CPU: bf16 parameters, fp32
    Adafactor moments, an int32 step."""
    spec = t_train.smoke_spec(t_registry.get_spec("kimi-k2-1t-a32b"))
    state = t_train.init_state(spec, t_build_bundle(spec, "train_4k", "cpu"))
    state["step"] = state["step"] + 7
    return state


def _bits(a):
    """Raw bytes of a host array or tensor (bf16 by its patterns)."""
    if isinstance(a, torch.Tensor):
        a = sync.host_read(a)
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("direction", ["port-port", "repro-port",
                                       "port-repro", "carry"])
def test_bf16_state_round_trips(direction, tmp_path):
    """A state with bf16 leaves, bitwise: written by the port and restored
    by the port or by ``repro`` (whose restore gives the ``V2`` records),
    written by ``repro`` and restored by the port; and carried as numpy
    (``state_from_tree`` of ``repro``'s arrays, ``snapshot`` back). The
    manifest says ``"bfloat16"`` with ``repro``'s crc32 of the bytes."""
    state = _kimi_state()
    flat = dict(flatten_with_paths(state))
    jstate = jax.tree.map(lambda a: np.asarray(a).view(ml_dtypes.bfloat16)
                          if sync.is_bf16_host(a.dtype) else a,
                          t_ckpt.snapshot(state))
    if direction == "carry":
        back = t_ckpt.snapshot(t_ckpt.state_from_tree(jstate, "cpu"))
        got = dict(flatten_with_paths(back))
    elif direction == "repro-port":
        j_ckpt.save_checkpoint(tmp_path, 7, jax.tree.map(jnp.asarray, jstate))
        restored, step = t_ckpt.restore_checkpoint(tmp_path, state)
        assert step == 7
        got = dict(flatten_with_paths(restored))
        assert all(got[k].dtype == v.dtype for k, v in flat.items())
    else:
        t_ckpt.save_checkpoint(tmp_path, 7, state)
        manifest = json.loads((tmp_path / "step_000000007" /
                               "manifest.json").read_text())["arrays"]
        for k, v in dict(flatten_with_paths(jstate)).items():
            assert manifest[k]["dtype"] == str(v.dtype), k
            assert manifest[k]["crc32"] == zlib.crc32(
                np.ascontiguousarray(v).tobytes()) & 0xFFFFFFFF, k
        if direction == "port-port":
            restored, step = t_ckpt.restore_checkpoint(tmp_path, state)
            got = dict(flatten_with_paths(restored))
            assert all(got[k].dtype == v.dtype for k, v in flat.items())
        else:
            restored, step = j_ckpt.restore_checkpoint(
                tmp_path, jax.tree.map(np.asarray, jstate))
            got = dict(flatten_with_paths(restored))
        assert step == 7
    assert got.keys() == flat.keys()
    assert any(v.dtype == torch.bfloat16 for v in flat.values())
    for k, v in flat.items():
        assert _bits(got[k]) == _bits(v), k
