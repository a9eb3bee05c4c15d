"""The training substrate of the PyTorch port against ``repro``'s on the
CPU: optimizers and schedules (``optim/``), checkpoints
(``checkpoint/``), the fault-tolerant runner (``fault/runner.py``) and
the synthetic data (``data/synthetic.py``).

Optimizer updates match ``repro``'s jitted ones to rtol 1e-5 and atol
1e-6 (float32; XLA fuses and reorders the arithmetic); schedule values
and synthetic arrays are bitwise. The checkpoint and runner cases are
twins of ``tests/test_substrate.py`` and ``tests/test_fault.py``: each
scenario runs through both packages' runners, with the same events and
states. Checkpoints restore across the packages in both directions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as j_ckpt
import repro.fault as j_fault
import repro.optim as j_optim
import repro_torch.checkpoint as t_ckpt
import repro_torch.fault as t_fault
import repro_torch.optim as t_optim
from repro.configs import registry as j_registry
from repro.data import synthetic as j_synth
from repro.launch import train as j_train
from repro_torch.configs import registry as t_registry
from repro_torch.core.sync import sync_count
from repro_torch.data import synthetic as t_synth
from repro_torch.launch import train as t_train
from repro_torch.obs import REGISTRY
from repro_torch.train.steps import build_bundle
from repro_torch.tree import flatten_with_paths, tree_map

RTOL, ATOL = 1e-5, 1e-6
FAULT = {"repro": j_fault, "port": t_fault}


def _np_tree(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_with_paths(tree)}


def _assert_trees_equal(a, b):
    a, b = _np_tree(a), _np_tree(b)
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -------------------------------------------------------------- optimizers
OPTIMIZERS = {
    "adamw": lambda m: m.adamw(lr=0.05),
    "adamw_sched_noclip": lambda m: m.adamw(
        lr=0.05, clip_norm=0.0, schedule=m.warmup_cosine(2, 10)),
    "adafactor": lambda m: m.adafactor(lr=0.05),
    "adafactor_sched_wd": lambda m: m.adafactor(
        lr=0.05, weight_decay=0.1, schedule=m.warmup_cosine(2, 10)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_repro(name):
    """Five updates on a mixed tree (a matrix and a vector) with seeded
    gradients: parameters, every state array and the gradient norm."""
    r = np.random.default_rng(0)
    p0 = {"m": r.standard_normal((3, 4)).astype(np.float32),
          "w": r.standard_normal(5).astype(np.float32)}
    grads = [{"m": 2 * r.standard_normal((3, 4)).astype(np.float32),
              "w": r.standard_normal(5).astype(np.float32)}
             for _ in range(5)]
    oj, ot = OPTIMIZERS[name](j_optim), OPTIMIZERS[name](t_optim)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    sj, st = oj.init(pj), ot.init(pt)
    upd = jax.jit(oj.update)
    for i, g in enumerate(grads):
        pj, sj, nj = upd({k: jnp.asarray(v) for k, v in g.items()}, sj, pj,
                         jnp.int32(i))
        pt, st, nt = ot.update({k: torch.from_numpy(v) for k, v in g.items()},
                               st, pt, torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(float(nt), float(nj), rtol=RTOL)
    for tree_j, tree_t in ((pj, pt), (sj, st)):
        a, b = _np_tree(jax.tree.map(np.asarray, tree_j)), _np_tree(tree_t)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_schedule_values_equal_repro():
    steps = np.array([0, 1, 5, 50, 1999, 2000, 2001, 50_000, 99_999,
                      100_000, 200_000], np.int32)
    a = np.asarray(j_optim.warmup_cosine(2000, 100_000)(jnp.asarray(steps)))
    b = t_optim.warmup_cosine(2000, 100_000)(torch.from_numpy(steps))
    assert b.dtype == torch.float32
    np.testing.assert_array_equal(b.numpy(), a)
    assert float(t_optim.constant()(torch.tensor(7))) == 1.0


@pytest.mark.parametrize("make_opt", [lambda: t_optim.adamw(lr=0.05,
                                                            clip_norm=1.0),
                                      lambda: t_optim.adafactor(lr=0.05)],
                         ids=["adamw", "adafactor"])
def test_optimizers_reduce_quadratic(make_opt):
    """Twin of test_substrate.py's case, on the port."""
    opt = make_opt()
    params = {"w": torch.tensor([3.0, -2.0]), "m": torch.ones((2, 2))}
    st = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["m"] ** 2)

    l0 = float(loss(params))
    for i in range(60):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
        params, st, _ = opt.update(g, st, params,
                                   torch.tensor(i, dtype=torch.int32))
    assert float(loss(params)) < l0 * 0.5


def test_adafactor_state_is_factored():
    st = t_optim.adafactor().init({"big": torch.zeros((64, 32)),
                                   "vec": torch.zeros((7,))})
    assert st["big"]["vr"].shape == (64,)
    assert st["big"]["vc"].shape == (32,)
    assert st["vec"]["v"].shape == (7,)


def test_update_leaves_its_arguments_alone():
    """The functional contract the runner's rollback rests on."""
    opt = t_optim.adamw(lr=0.1)
    params = {"w": torch.ones(3)}
    st = opt.init(params)
    g = {"w": torch.full((3,), 0.5)}
    before = [t.clone() for t in (params["w"], st["mu"]["w"], st["nu"]["w"],
                                  g["w"])]
    new_p, new_s, _ = opt.update(g, st, params, torch.tensor(3))
    for a, b in zip(before, (params["w"], st["mu"]["w"], st["nu"]["w"],
                             g["w"])):
        assert torch.equal(a, b)
    assert not torch.equal(new_p["w"], params["w"])


# ------------------------------------------------------------- checkpoint
def _state(x=0.0):
    return {"params": {"w": torch.full((4, 3), x), "b": torch.zeros(3)},
            "step": torch.tensor(0, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    st = _state(1.5)
    t_ckpt.save_checkpoint(tmp_path, 10, st)
    got, step = t_ckpt.restore_checkpoint(tmp_path, st)
    assert step == 10
    _assert_trees_equal(got, st)


def test_checkpoint_retention_and_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        t_ckpt.save_checkpoint(tmp_path, s, _state(s), keep=2)
    assert t_ckpt.latest_step(tmp_path) == 5
    assert len(list(tmp_path.glob("step_*"))) == 2


def test_checkpoint_corruption_detected(tmp_path):
    t_ckpt.save_checkpoint(tmp_path, 1, _state(1.0))
    t_ckpt.save_checkpoint(tmp_path, 2, _state(2.0))
    victim = tmp_path / "step_000000002" / "arrays.npz"
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))
    got, step = t_ckpt.restore_checkpoint(tmp_path, _state())
    assert step == 1           # fell back past the corrupted checkpoint
    assert torch.equal(got["params"]["w"], torch.full((4, 3), 1.0))


def test_checkpoint_restores_onto_another_device(tmp_path):
    """The counterpart of the elastic re-shard: a state laid out on one
    device (here ``meta``, no storage) restores onto ``device=``."""
    t_ckpt.save_checkpoint(tmp_path, 7, _state(3.0))
    like = {"params": {"w": torch.empty((4, 3), device="meta"),
                       "b": torch.empty(3, device="meta")},
            "step": torch.empty((), dtype=torch.int32, device="meta")}
    got, step = t_ckpt.restore_checkpoint(tmp_path, like, device="cpu")
    assert step == 7
    assert got["params"]["w"].device.type == "cpu"
    _assert_trees_equal(got, _state(3.0))


def test_async_checkpoint_manager_snapshots_a_copy(tmp_path):
    mgr = t_ckpt.CheckpointManager(tmp_path, every=2)
    for s in range(1, 7):
        mgr.maybe_save(s, _state(float(s)))
    mgr.wait()
    assert t_ckpt.latest_step(tmp_path) == 6
    # an in-place update right after maybe_save must not reach the
    # checkpoint being written (a CPU tensor's numpy view shares memory)
    st = _state(1.0)
    mgr = t_ckpt.CheckpointManager(tmp_path / "b", every=1)
    assert mgr.maybe_save(1, st)
    st["params"]["w"].add_(100.0)
    got, _ = mgr.restore_latest(_state())
    assert torch.equal(got["params"]["w"], torch.full((4, 3), 1.0))


def _gcn_states():
    """``gcn-cora``'s smoke state in both packages (the port's carries
    ``repro``'s values)."""
    jspec = j_train.smoke_spec(j_registry.get_spec("gcn-cora"))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh:
        from repro.train.steps import build_bundle as j_build
        jstate = j_train.init_state(jspec, mesh,
                                    j_build(jspec, "full_graph_sm", mesh))
    host = jax.tree.map(np.asarray, jstate)
    return jstate, t_ckpt.state_from_tree(host, "cpu"), host


def test_checkpoint_repro_writes_port_restores(tmp_path):
    jstate, tstate, host = _gcn_states()
    j_ckpt.save_checkpoint(tmp_path, 4, jstate)
    got, step = t_ckpt.restore_checkpoint(tmp_path,
                                          tree_map(torch.zeros_like, tstate))
    assert step == 4
    assert set(_np_tree(got)) == {"params/w0", "params/w1", "opt/mu/w0",
                                  "opt/mu/w1", "opt/nu/w0", "opt/nu/w1",
                                  "step"}
    _assert_trees_equal(got, host)


def test_checkpoint_port_writes_repro_restores(tmp_path):
    jstate, tstate, host = _gcn_states()
    bumped = dict(tstate, step=torch.tensor(9, dtype=torch.int32),
                  params={k: v + 1.0 for k, v in tstate["params"].items()})
    t_ckpt.save_checkpoint(tmp_path, 9, bumped)
    got, step = j_ckpt.restore_checkpoint(tmp_path, jstate)
    assert step == 9
    _assert_trees_equal(jax.tree.map(np.asarray, got), bumped)


def test_state_from_tree_places_every_leaf():
    tree = {"a": {"b": np.arange(3, dtype=np.int32)}, "c": np.float32(2.0)}
    st = t_ckpt.state_from_tree(tree, "cpu")
    assert st["a"]["b"].dtype == torch.int32 and st["c"].dim() == 0
    _assert_trees_equal(st, tree)


# ------------------------------------------------------------------ runner
def _mk_runner(pkg, tmp_path, fail_plan=None, nan_steps=(), **cfg_kw):
    """test_fault.py's loop on ``pkg``'s runner: state = {'x': sum of the
    batch values consumed so far}; fail_plan maps step -> number of
    times that step raises before succeeding."""
    fail_plan = dict(fail_plan or {})
    nan_steps = set(nan_steps)
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        step = int(batch) - 1
        if fail_plan.get(step, 0) > 0:
            fail_plan[step] -= 1
            raise RuntimeError(f"injected fault @ step {step}")
        loss = np.nan if step in nan_steps else 1.0 / batch
        return {"x": state["x"] + batch}, {"loss": np.float32(loss)}

    m = FAULT[pkg]
    cfg = m.RunnerConfig(ckpt_dir=str(tmp_path / pkg), ckpt_every=2,
                         handle_sigterm=False, **cfg_kw)
    return m.FaultTolerantRunner(step_fn, {"x": np.float64(0.0)},
                                 lambda s: float(s + 1), cfg), calls


def _both(tmp_path, n_steps, **kw):
    """Run one scenario on both runners; same events, state and calls."""
    out = {}
    for pkg in FAULT:
        runner, calls = _mk_runner(pkg, tmp_path, **kw)
        state = runner.run(n_steps)
        out[pkg] = (float(state["x"]), runner.step,
                    [(s, k) for s, k, _ in runner.events], calls["n"],
                    len(runner.monitor.history))
    assert out["port"] == out["repro"]
    return out["port"]


def test_runner_clean_run_accumulates_and_checkpoints(tmp_path):
    x, step, events, calls, _ = _both(tmp_path, 6)
    assert x == sum(range(1, 7)) and calls == 6 and events == []
    fresh, _ = _mk_runner("port", tmp_path)
    assert fresh.restore() == 6
    assert float(fresh.state["x"]) == sum(range(1, 7))


def test_runner_retries_injected_fault_with_rollback_accounting(tmp_path):
    x, _, events, calls, _ = _both(tmp_path, 5, fail_plan={3: 2},
                                   max_retries=3)
    assert x == sum(range(1, 6))
    assert [k for _, k in events] == ["step_failure", "rollback",
                                      "step_failure", "rollback"]
    assert calls == 5 + 2 + 2


def test_runner_raises_after_max_retries(tmp_path):
    for pkg in FAULT:
        runner, _ = _mk_runner(pkg, tmp_path, fail_plan={2: 99},
                               max_retries=2)
        with pytest.raises(RuntimeError, match="injected fault @ step 2"):
            runner.run(4)
        failures = [e for e in runner.events if e[1] == "step_failure"]
        assert len(failures) == 3 and all(e[0] == 2 for e in failures)


def test_runner_nan_loss_rolls_back_and_skips_window(tmp_path):
    x, step, events, _, _ = _both(tmp_path, 6, nan_steps={3})
    assert [k for _, k in events] == ["nan_loss", "rollback"]
    assert x == sum(range(1, 7)) - 4.0 - 3.0 and step == 6


def test_runner_nan_tolerance_allows_transient_spike(tmp_path):
    _, step, events, _, _ = _both(tmp_path, 6, nan_steps={3},
                                  nan_tolerance=1)
    assert [k for _, k in events] == ["nan_loss"] and step == 6


def test_runner_straggler_monitor_sees_every_committed_step(tmp_path):
    *_, history = _both(tmp_path, 4, fail_plan={3: 1})
    assert history == 4 + 1


def _toy_step(fail_at=(), nan_batches=()):
    """test_substrate.py's toy step on torch tensors: NaN keys off the
    data window, injected failures off the state step."""
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        s = int(state["step"])
        data_id = int(batch["x"][0]) - 1
        if s in fail_at and calls.setdefault(f"f{s}", 0) == 0:
            calls[f"f{s}"] = 1
            raise RuntimeError(f"injected device failure at {s}")
        loss = torch.tensor(float("nan")) if data_id in nan_batches else \
            torch.tensor(1.0 / (s + 1.0)) + 0.0 * batch["x"].sum()
        return dict(state, step=state["step"] + 1,
                    w=state["w"] + batch["x"].mean()), {"loss": loss}
    return step, calls


def _toy_runner(tmp_path, step):
    return t_fault.FaultTolerantRunner(
        step, {"w": torch.zeros(()), "step": torch.tensor(0, dtype=torch.int32)},
        lambda s: {"x": torch.full((4,), float(s + 1))},
        t_fault.RunnerConfig(str(tmp_path), ckpt_every=2,
                             handle_sigterm=False))


def test_runner_recovers_from_failure_on_tensors(tmp_path):
    step, _ = _toy_step(fail_at=(5,))
    r = _toy_runner(tmp_path, step)
    assert int(r.run(10)["step"]) == 10
    kinds = [k for _, k, _ in r.events]
    assert "step_failure" in kinds and "rollback" in kinds


def test_runner_nan_rollback_skips_bad_window_on_tensors(tmp_path):
    step, _ = _toy_step(nan_batches=(4,))
    r = _toy_runner(tmp_path, step)
    out = r.run(8)
    assert r.step == 8 and int(out["step"]) == 7
    assert any(k == "nan_loss" for _, k, _ in r.events)


def test_runner_resume_across_restart_on_tensors(tmp_path):
    step, _ = _toy_step()
    _toy_runner(tmp_path, step).run(6)
    r2 = _toy_runner(tmp_path, step)
    assert r2.restore() == 6
    assert int(r2.run(9)["step"]) == 9


def test_runner_reads_one_loss_a_step_and_counts_events(tmp_path):
    """One counted ``host_read`` a step, plus one a checkpoint snapshot;
    the audit events count into ``fault.events{kind}``."""
    step, _ = _toy_step(fail_at=(3,))
    r = _toy_runner(tmp_path, step)
    events = REGISTRY.counter("fault.events")
    before = events.value(kind="rollback")
    s0 = sync_count()
    r.run(6)
    # 6 committed steps + step 2 replayed after the rollback to its
    # checkpoint (the failed attempt raised before its read); snapshots
    # at 2, 4, 6 and the final forced save
    assert sync_count() - s0 == (6 + 1) + 4
    assert events.value(kind="rollback") == before + 1


@pytest.fixture(scope="module")
def gcn_bundle():
    spec = t_train.smoke_spec(t_registry.get_spec("gcn-cora"))
    bundle = build_bundle(spec, "full_graph_sm", "cpu")
    return (bundle, t_train.init_state(spec, bundle),
            t_train.make_batch_fn(spec, "full_graph_sm", device="cpu"))


@pytest.mark.parametrize("ckpt_every", [0, 2], ids=["no_ckpt", "ckpt2"])
def test_runner_fault_after_optimizer_keeps_prior_state(tmp_path, gcn_bundle,
                                                        ckpt_every):
    """A step that fails after the optimizer has run leaves the runner's
    state as it was before that step: the step is functional, and the
    runner assigns a step's result only after its loss read."""
    bundle, state0, make_batch = gcn_bundle
    seen = {}

    def failing(state, batch):
        new_state, metrics = bundle.fn(state, batch)   # optimizer has run
        if int(state["step"]) == 3 and "failed" not in seen:
            seen["failed"] = True
            seen["before"] = {k: v.clone()
                              for k, v in _np_state(state).items()}
            seen["state"] = state
            raise RuntimeError("injected fault after the optimizer")
        return new_state, metrics

    cfg = t_fault.RunnerConfig(str(tmp_path / "a"), ckpt_every=ckpt_every,
                               handle_sigterm=False)
    runner = t_fault.FaultTolerantRunner(failing, state0, make_batch, cfg)
    hit = {}
    orig = runner._rollback

    def rollback(*a, **kw):
        # at the rollback the runner still holds the pre-step state,
        # unchanged by the step that ran on it
        hit["same"] = runner.state is seen["state"]
        for k, v in _np_state(runner.state).items():
            assert torch.equal(v, seen["before"][k]), k
        orig(*a, **kw)

    runner._rollback = rollback
    out = runner.run(6)
    assert hit["same"]
    assert [k for _, k, _ in runner.events] == ["step_failure", "rollback"]
    clean = t_fault.FaultTolerantRunner(
        bundle.fn, state0, make_batch,
        t_fault.RunnerConfig(str(tmp_path / "b"), ckpt_every=ckpt_every,
                             handle_sigterm=False)).run(6)
    _assert_trees_equal(out, clean)
    # the initial state was never touched
    _assert_trees_equal(state0, t_train.init_state(
        t_train.smoke_spec(t_registry.get_spec("gcn-cora")), bundle))


def _np_state(state):
    return dict(flatten_with_paths(state))


# -------------------------------------------------------------------- data
def test_synthetic_batches_equal_repro_and_seekable():
    for step in (0, 5, 6):
        for fn, args in (("lm_batch", (4, 16, 100)),
                         ("dien_batch", (8, 10, 500, 20, 50))):
            a = getattr(j_synth, fn)(0, step, *args)
            b = getattr(t_synth, fn)(0, step, *args)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    a, c = t_synth.lm_batch(0, 5, 4, 16, 100), t_synth.lm_batch(0, 6, 4, 16,
                                                                100)
    assert (a["tokens"] != c["tokens"]).any()
    np.testing.assert_array_equal(
        t_synth.lm_batch(0, 5, 4, 16, 100, host_slice=slice(1, 3))["tokens"],
        a["tokens"][1:3])
