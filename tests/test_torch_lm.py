"""The LM serving slice of the PyTorch port against ``repro`` on the CPU:
``models/{layers,attention,moe,transformer}.py``, the five LM configs,
``build_lm_bundle`` and ``launch/serve.py --mode lm``. The train kind of
``build_lm_bundle`` is checked here for its outputs only; its parity with
``repro``'s train step is ``tests/test_torch_lm_train.py``.

``repro``'s parameters come from ``init_lm(PRNGKey(0), tiny_like(cfg))``
with ``bq bk bv`` redrawn non-zero (``repro``'s init sets them to zero,
which would leave the bias path untested), carried across with
``transformer.state_from_tree``. ``repro``'s functions run without a
mesh (under one its jitted train steps are among the reference
failures). Its
functions run under ``jax.jit`` with the config static, each compiled
once a config and shape and shared by the tests: an eager ``lax.scan``
traces and compiles its body anew on every call, and eager ``jnp``
compiles each op alone.

Tolerances. XLA's and torch's ``silu``, ``softmax``, ``rsqrt``, ``cos``
and means differ by a few ulps in fp32, and ``silu`` in bf16 differs in
the last bit on a third of the elements, so the parity is a tolerance:
``FP32`` (rtol 1e-5, atol 1e-5 on values of order 1) at
``LMConfig(dtype="float32")`` and ``BF16`` (``repro``'s own 5e-2, rtol
and atol, as in ``tests/test_arch_smoke.py``) in bf16. The MoE routing
(``top_i``, ``slot``, ``keep``), the cache length, the greedy tokens and
the weight round trip are bitwise.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro_torch.configs import registry as t_registry
from repro_torch.configs import shapes as t_shapes
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.train.steps import build_bundle
from repro_torch.tree import flatten_with_paths, unflatten_paths

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
TOL = {"float32": FP32, "bfloat16": BF16}
DTYPES = ("float32", "bfloat16")
ARCHS = ("granite-8b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "yi-34b",
         "qwen2-72b")
DECODE_STEPS = 4

J_PREFILL = jax.jit(j_tf.prefill, static_argnums=(1, 3))
J_DECODE = jax.jit(j_tf.decode_step, static_argnums=1)
J_RMSNORM = jax.jit(j_layers.rmsnorm)
J_LAYERNORM = jax.jit(j_layers.layernorm)
J_SWIGLU = jax.jit(j_layers.swiglu, static_argnums=2)
J_ROPE = jax.jit(j_layers.apply_rope, static_argnums=2)
J_CE = jax.jit(j_layers.softmax_cross_entropy,
               static_argnames=("z_loss", "impl"))
J_CAUSAL = jax.jit(j_attn.causal_attention, static_argnums=1,
                   static_argnames=("q_chunk", "dtype"))
J_DECODE_ATTN = jax.jit(j_attn.decode_attention, static_argnums=1,
                        static_argnames="dtype")
J_MOE = jax.jit(j_moe.moe_ffn, static_argnums=1, static_argnames="dtype")


@functools.partial(jax.jit, static_argnums=1)
def j_forward_and_losses(p, cfg, tokens, targets, mask):
    """``repro``'s ``forward`` and its ``lm_loss`` without and with
    ``mask``, in one compile."""
    return (j_tf.forward(p, cfg, tokens), j_tf.lm_loss(p, cfg, tokens, targets),
            j_tf.lm_loss(p, cfg, tokens, targets, mask))


def _np(x):
    """A jax array or a torch tensor as fp32 numpy (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                               **TOL[dtype])


def _tree(state):
    """The port's module state (dotted) as the nested tree its functions
    take."""
    return unflatten_paths((k.replace(".", "/"), v) for k, v in state.items())


def _with_bias(tree, seed):
    """``repro``'s tree with every ``bq bk bv`` redrawn N(0, 0.5)."""
    r = np.random.default_rng(seed)
    out = {}
    for path, leaf in flatten_with_paths(tree):
        a = np.asarray(leaf)
        if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
            a = (0.5 * r.standard_normal(a.shape)).astype(a.dtype)
        out[path] = a
    return unflatten_paths(out.items())


def _cfgs(arch, dtype):
    jc = j_tf.tiny_like(j_registry.get_spec(arch).model_cfg)
    tc = t_tf.tiny_like(t_registry.get_spec(arch).model_cfg)
    return (dataclasses.replace(jc, dtype=dtype),
            dataclasses.replace(tc, dtype=dtype))


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """One tiny config a module: ``repro``'s parameters (numpy tree,
    biases non-zero), on both sides."""
    arch = request.param
    jc, _ = _cfgs(arch, "float32")
    tree = _with_bias(jax.tree.map(np.asarray,
                                   j_tf.init_lm(jax.random.PRNGKey(0), jc)[0]),
                      seed=1)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = _tree(t_tf.state_from_tree(tree, "cpu"))
    return arch, tree, jp, tp


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", DTYPES)
def test_layers_against_repro(dtype):
    r = np.random.default_rng(0)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x = r.standard_normal((3, 5, 16)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    scale = (1 + 0.1 * r.standard_normal(16)).astype(np.float32)
    bias = (0.1 * r.standard_normal(16)).astype(np.float32)
    _close(t_layers.rmsnorm({"scale": torch.from_numpy(scale)}, xt),
           J_RMSNORM({"scale": jnp.asarray(scale)}, xj), dtype,
           "rmsnorm")
    ln = {"scale": scale, "bias": bias}
    _close(t_layers.layernorm({k: torch.from_numpy(v) for k, v in ln.items()},
                              xt),
           J_LAYERNORM({k: jnp.asarray(v) for k, v in ln.items()}, xj),
           dtype, "layernorm")
    sw = {k: (r.standard_normal(s) / 4).astype(np.float32) for k, s in
          (("w_gate", (16, 32)), ("w_up", (16, 32)), ("w_down", (32, 16)))}
    _close(t_layers.swiglu({k: torch.from_numpy(v) for k, v in sw.items()},
                           xt, td),
           J_SWIGLU({k: jnp.asarray(v) for k, v in sw.items()}, xj,
                           jd), dtype, "swiglu")
    q = r.standard_normal((2, 7, 3, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7) + 5, (2, 7))
    _close(t_layers.apply_rope(torch.from_numpy(q).to(td),
                               torch.from_numpy(pos.copy()), 5e5),
           J_ROPE(jnp.asarray(q).astype(jd), jnp.asarray(pos),
                               5e5), dtype, "apply_rope")
    logits = (3 * r.standard_normal((4, 6, 40))).astype(np.float32)
    labels = r.integers(0, 40, (4, 6)).astype(np.int32)
    for impl in ("gather", "iota"):
        for z in (0.0, 1e-4):
            got = t_layers.softmax_cross_entropy(
                torch.from_numpy(logits).to(td), torch.from_numpy(labels),
                z_loss=z, impl=impl)
            want = J_CE(
                jnp.asarray(logits).astype(jd), jnp.asarray(labels),
                z_loss=z, impl=impl)
            _close(got, want, dtype, f"softmax_cross_entropy {impl} z={z}")


# ------------------------------------------------------------- attention
def _attn_params(cfg, seed):
    r = np.random.default_rng(seed)
    h, kv, dh, e = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    shapes = {"wq": (e, h * dh), "wk": (e, kv * dh), "wv": (e, kv * dh),
              "wo": (h * dh, e), "bq": (h * dh,), "bk": (kv * dh,),
              "bv": (kv * dh,)}
    return {k: (r.standard_normal(s) / np.sqrt(s[0] if len(s) == 2 else 4))
            .astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_against_repro(dtype):
    """``causal_attention`` at S = 12 with ``q_chunk`` 8 (two chunks of
    6) with ``qkv_bias``, then ``decode_attention`` on one
    cache handed to both packages (the port's a clone, written in
    place), at cache lengths 3, Smax - 1 and Smax + 2 (the write clamps
    to the last slot and the mask is all true)."""
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    cfg_j = j_attn.AttnConfig(32, 4, 2, 8, 1e4, qkv_bias=True)
    cfg_t = t_attn.AttnConfig(32, 4, 2, 8, 1e4, qkv_bias=True)
    p = _attn_params(cfg_j, 3)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 12, 32)).astype(np.float32)
    yj, (kj, vj) = J_CAUSAL(
        pj, cfg_j, jnp.asarray(x).astype(jd), q_chunk=8, dtype=jd)
    yt, (kt, vt) = t_attn.causal_attention(
        pt, cfg_t, torch.from_numpy(x).to(td), q_chunk=8, dtype=td)
    assert [t_attn.q_chunk_size(s, 8) for s in (12, 13, 16)] == [6, 1, 8]
    _close(yt, yj, dtype, "causal_attention y")
    _close(kt, kj, dtype, "causal_attention k")
    _close(vt, vj, dtype, "causal_attention v")
    smax = 10
    ck = (r.standard_normal((2, smax, 2, 8))).astype(np.float32)
    cv = (r.standard_normal((2, smax, 2, 8))).astype(np.float32)
    for n in (3, smax - 1, smax + 2):
        x = r.standard_normal((2, 1, 32)).astype(np.float32)
        ckj, cvj = jnp.asarray(ck).astype(jd), jnp.asarray(cv).astype(jd)
        ckt, cvt = (torch.from_numpy(ck).to(td).clone(),
                    torch.from_numpy(cv).to(td).clone())
        yj, nkj, nvj = J_DECODE_ATTN(
            pj, cfg_j, jnp.asarray(x).astype(jd), ckj, cvj, jnp.int32(n),
            dtype=jd)
        yt, nkt, nvt = t_attn.decode_attention(
            pt, cfg_t, torch.from_numpy(x).to(td), ckt, cvt,
            torch.tensor(n, dtype=torch.int32), dtype=td)
        assert nkt is ckt and nvt is cvt          # written in place
        _close(yt, yj, dtype, f"decode_attention y len={n}")
        _close(nkt, nkj, dtype, f"decode_attention k len={n}")
        _close(nvt, nvj, dtype, f"decode_attention v len={n}")
        slot = min(n, smax - 1)
        rest = [i for i in range(smax) if i != slot]
        np.testing.assert_array_equal(_np(nkt[:, rest]),
                                      _np(torch.from_numpy(ck).to(td)[:, rest]))


# ------------------------------------------------------------------- MoE
MOE_KW = dict(n_experts=16, top_k=2, d_expert_ff=8, n_shared=1, d_shared_ff=8,
              ep_pad=20)


def _moe_params(seed, e=16, tie=False):
    """Expert weights for ``MOE_KW``; ``tie``: router columns 1 and 2
    equal and below column 0, the rest small (every token's top 2 is
    expert 0 and a tie between 1 and 2)."""
    r = np.random.default_rng(seed)
    n, f = MOE_KW["ep_pad"], MOE_KW["d_expert_ff"]
    p = {"router": (r.standard_normal((e, 16)) / 4).astype(np.float32),
         "w_gate": (r.standard_normal((n, e, f)) / 4).astype(np.float32),
         "w_up": (r.standard_normal((n, e, f)) / 4).astype(np.float32),
         "w_down": (r.standard_normal((n, f, e)) / 3).astype(np.float32),
         "shared": {"w_gate": (r.standard_normal((e, 8)) / 4)
                    .astype(np.float32),
                    "w_up": (r.standard_normal((e, 8)) / 4).astype(np.float32),
                    "w_down": (r.standard_normal((8, e)) / 3)
                    .astype(np.float32)}}
    if tie:
        p["router"] = (0.01 * r.standard_normal((e, 16))).astype(np.float32)
        p["router"][:, 0] = 1.0
        p["router"][:, 1] = p["router"][:, 2] = 0.5
    return p


def _repro_routing(p, cfg, x):
    """``repro.models.moe.moe_ffn``'s routing lines (moe.py:90-106) on
    ``x`` [T, E] in fp32: (probs, top_i, slot, keep)."""
    return tuple(np.asarray(a) for a in _j_routing(p, cfg, x))


@functools.partial(jax.jit, static_argnums=1)
def _j_routing(p, cfg, x):
    logits = (x @ p["router"]).astype(jnp.float32)
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
    slot = jnp.where(keep, sorted_e * cap + rank, n * cap)
    return probs, top_i, slot, keep


def _moe_case(p, x, impl, dtype):
    jc = j_moe.MoEConfig(combine_impl=impl, **MOE_KW)
    tc = t_moe.MoEConfig(combine_impl=impl, **MOE_KW)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    pj = jax.tree.map(jnp.asarray, p)
    pt = jax.tree.map(torch.from_numpy, p)
    yj, aj = J_MOE(pj, jc, jnp.asarray(x).astype(jd), dtype=jd)
    yt, at = t_moe.moe_ffn(pt, tc, torch.from_numpy(x).to(td), dtype=td)
    _close(yt, yj, dtype, f"moe_ffn y {impl}")
    np.testing.assert_allclose(float(at), float(aj), **TOL[dtype])
    xf = x.reshape(-1, x.shape[-1])
    ref = _repro_routing(pj, jc, jnp.asarray(xf))
    got = t_moe.route(pt, tc, torch.from_numpy(xf), torch.float32)
    return ref, got


@pytest.mark.parametrize("impl", ["gather", "scatter"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_against_repro(impl, dtype):
    """``moe_ffn`` with ``ep_pad`` 20 > 16 experts, both combines; the
    fp32 routing bitwise on inputs whose top-k margin is above 1e-4."""
    x = np.random.default_rng(5).standard_normal((2, 6, 16)).astype(
        np.float32)
    (probs, top_i, slot, keep), got = _moe_case(_moe_params(6), x, impl,
                                                dtype)
    srt = -np.sort(-probs, axis=-1)
    assert (srt[:, :MOE_KW["top_k"]] - srt[:, 1:MOE_KW["top_k"] + 1]).min() \
        > 1e-4
    np.testing.assert_array_equal(got.top_i.numpy(), top_i)
    np.testing.assert_array_equal(got.slot.numpy(), slot)
    np.testing.assert_array_equal(got.keep.numpy(), keep)


@pytest.mark.parametrize("impl", ["gather", "scatter"])
def test_moe_ties_and_drops(impl):
    """Router columns 1 and 2 equal: the lower expert wins the tie in the
    top 2 (``jax.lax.top_k``'s rule; ``torch.topk`` picks 2). Then a
    decode-sized batch (4 tokens: capacity 1) where every token routes
    to experts 0 and 1, so 3 of 4 assignments of each are dropped."""
    p = _moe_params(7, tie=True)
    x = np.abs(np.random.default_rng(8).standard_normal((2, 5, 16))).astype(
        np.float32)
    (probs, top_i, slot, keep), got = _moe_case(p, x, impl, "float32")
    assert (probs[:, 1] == probs[:, 2]).all()
    assert (got.probs[:, 1] == got.probs[:, 2]).all()
    np.testing.assert_array_equal(top_i, np.tile([0, 1], (10, 1)))
    np.testing.assert_array_equal(got.top_i.numpy(), top_i)
    np.testing.assert_array_equal(got.slot.numpy(), slot)
    np.testing.assert_array_equal(got.keep.numpy(), keep)

    xd = x[:, :2]                                  # 4 tokens of 1 step each
    (_, top_i, slot, keep), got = _moe_case(p, xd.reshape(4, 1, 16), impl,
                                            "float32")
    assert got.cap == 1 and int(keep.sum()) == 2
    np.testing.assert_array_equal(got.top_i.numpy(), top_i)
    np.testing.assert_array_equal(got.slot.numpy(), slot)
    np.testing.assert_array_equal(got.keep.numpy(), keep)


# ------------------------------------------------------------ the five LMs
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_loss_against_repro(lm, dtype):
    arch, _, jp, tp = lm
    jc, tc = _cfgs(arch, dtype)
    r = np.random.default_rng(9)
    toks = r.integers(0, jc.vocab, (2, 12)).astype(np.int32)
    tgts = r.integers(0, jc.vocab, (2, 12)).astype(np.int32)
    mask = (r.random((2, 12)) < 0.7).astype(np.float32)
    (lj, aj), *losses = j_forward_and_losses(
        jp, jc, jnp.asarray(toks), jnp.asarray(tgts), jnp.asarray(mask))
    lt, at = t_tf.forward(tp, tc, torch.from_numpy(toks))
    assert lt.dtype == torch.float32 and lt.shape == (2, 12, jc.vocab)
    _close(lt, lj, dtype, f"{arch} logits")
    np.testing.assert_allclose(float(at), float(aj), **TOL[dtype])
    for m, want in zip((None, mask), losses):
        got = t_tf.lm_loss(tp, tc, torch.from_numpy(toks),
                           torch.from_numpy(tgts),
                           None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_against_repro(lm, dtype):
    """Prefill 8 tokens into a cache of 16, then 4 teacher-forced decode
    steps: logits and the cache (``k``, ``v``, ``len``) after each."""
    arch, _, jp, tp = lm
    jc, tc = _cfgs(arch, dtype)
    toks = np.random.default_rng(10).integers(
        0, jc.vocab, (2, 8 + DECODE_STEPS)).astype(np.int32)
    with torch.no_grad():
        lj, cj = J_PREFILL(jp, jc, jnp.asarray(toks[:, :8]), 16)
        lt, ct = t_tf.prefill(tp, tc, torch.from_numpy(toks[:, :8]), 16)
        for step in range(DECODE_STEPS + 1):
            what = f"{arch} step {step}"
            _close(lt, lj, dtype, f"{what} logits")
            for key in ("k", "v"):
                assert ct[key].dtype == getattr(torch, dtype)
                _close(ct[key], cj[key], dtype, f"{what} cache {key}")
            assert int(ct["len"]) == int(cj["len"]) == 8 + step
            if step == DECODE_STEPS:
                break
            nxt = toks[:, 8 + step:9 + step]
            lj, cj = J_DECODE(jp, jc, cj, jnp.asarray(nxt))
            lt, ct2 = t_tf.decode_step(tp, tc, ct, torch.from_numpy(nxt))
            assert ct2 is ct                            # in place
    with pytest.raises(ValueError):
        t_tf.prefill(tp, tc, torch.from_numpy(toks), 11)


def test_odd_token_ids(lm):
    """Ids V, V + 3, -1, -V and -V - 1 read rows V - 1, V - 1, V - 1, 0
    and 0 (jnp's gather rule) through ``forward`` and ``prefill`` (the
    other tests' shapes: ``repro``'s functions are compiled already)."""
    arch, _, jp, tp = lm
    jc, tc = _cfgs(arch, "float32")
    v = jc.vocab
    odd = np.array([[v, v + 3, -1, -v, -v - 1, 5] * 2,
                    [-v - 1, -v, -1, v + 3, v, 7] * 2], np.int32)
    rows = np.array([[v - 1, v - 1, v - 1, 0, 0, 5] * 2,
                     [0, 0, v - 1, v - 1, v - 1, 7] * 2], np.int32)
    np.testing.assert_array_equal(
        t_tf.token_rows(torch.from_numpy(odd), v).numpy(), rows)
    lt, _ = t_tf.forward(tp, tc, torch.from_numpy(odd))
    assert torch.equal(lt, t_tf.forward(tp, tc, torch.from_numpy(rows))[0])
    want = j_forward_and_losses(jp, jc, jnp.asarray(odd),
                                jnp.zeros_like(odd), jnp.ones(odd.shape))
    _close(lt, want[0][0], "float32", f"{arch} forward")
    pt, _ = t_tf.prefill(tp, tc, torch.from_numpy(odd[:, :8]), 16)
    _close(pt, J_PREFILL(jp, jc, jnp.asarray(odd[:, :8]), 16)[0],
           "float32", f"{arch} prefill")


def test_weight_round_trip(lm):
    """``repro`` tree -> port state -> ``repro`` tree, bitwise; the state
    loads into the port's ``LM`` module, whose tree has ``repro``'s
    paths and shapes."""
    arch, tree, _, _ = lm
    _, tc = _cfgs(arch, "float32")
    state = t_tf.state_from_tree(tree, "cpu")
    back = t_tf.tree_from_state(state)
    a, b = dict(flatten_with_paths(tree)), dict(flatten_with_paths(back))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    with torch.device("meta"):
        model = t_tf.LM(tc)
    model.load_state_dict(state, assign=True)
    assert all(p.data_ptr() == state[k].data_ptr()
               for k, p in model.named_parameters())
    assert {k: tuple(v.shape) for k, v in
            flatten_with_paths(t_tf.abstract_params(tc))} == \
        {k: v.shape for k, v in a.items()}


# ------------------------------------------------------- bundles, launcher
def test_lm_bundles_on_a_smoke_spec():
    """``build_bundle(spec, "prefill_32k")`` and ``"decode_32k"`` on the
    smoke config in fp32, with those cells cut to 16 tokens and 2
    sequences, against ``repro``'s ``prefill``/``decode_step`` (what its
    bundles call) on the bundle's parameters; the ``train`` kind's step
    returns ``{"loss", "gnorm"}`` and a new state, its input untouched
    (its parity with ``repro``: ``tests/test_torch_lm_train.py``)."""
    arch = "qwen2-moe-a2.7b"
    shapes = {"prefill_32k": ("prefill", 16, 2), "decode_32k":
              ("decode", 16, 2), "train_4k": ("train", 16, 2)}
    jc = dataclasses.replace(j_tf.tiny_like(
        j_registry.get_spec(arch).model_cfg), dtype="float32")
    spec = t_train.smoke_spec(t_registry.get_spec(arch))
    spec = dataclasses.replace(
        spec, model_cfg=dataclasses.replace(spec.model_cfg, dtype="float32"),
        shapes={k: t_shapes.LMShape(k, *v) for k, v in shapes.items()})
    pre = build_bundle(spec, "prefill_32k", "cpu")
    dec = build_bundle(spec, "decode_32k", "cpu")
    assert pre.static_meta["cfg"] == spec.model_cfg
    assert spec.input_specs("decode_32k")["cache"]["k"].shape == \
        (2, 2, 16, 2, 8)
    assert spec.runnable_cells() == list(shapes)
    assert "long_500k" not in t_registry.get_spec(arch).runnable_cells()
    train = build_bundle(spec, "train_4k", "cpu")
    st0 = t_train.init_state(spec, train)
    before = {k: v.clone() for k, v in flatten_with_paths(st0)}
    st1, metrics = train.fn(st0, t_train.make_batch_fn(
        spec, "train_4k", device="cpu")(0))
    assert set(metrics) == {"loss", "gnorm"}
    assert all(torch.isfinite(v) and v.shape == () for v in metrics.values())
    assert set(st1) == {"params", "opt", "step"} and int(st1["step"]) == 1
    assert all(torch.equal(v, before[k]) for k, v in flatten_with_paths(st0))
    assert all(a is not b for (_, a), (_, b) in zip(
        flatten_with_paths(st1["params"]), flatten_with_paths(st0["params"])))
    state = t_train.init_state(spec, pre)
    assert set(state) == {"params"}
    jp = jax.tree.map(jnp.asarray, t_tf.tree_from_state(
        t_layers.dotted(state["params"])))
    toks = np.random.default_rng(11).integers(0, 64, (2, 10)).astype(np.int32)
    lj, cj = J_PREFILL(jp, jc, jnp.asarray(toks[:, :8]), 16)
    lt, ct = pre.fn(state["params"], {"tokens": torch.from_numpy(
        toks[:, :8])})
    _close(lt, lj, "float32", "prefill bundle")
    for i in range(8, 10):
        lj, cj = J_DECODE(jp, jc, cj, jnp.asarray(toks[:, i:i + 1]))
        lt, ct = dec.fn(state["params"], ct,
                        torch.from_numpy(toks[:, i:i + 1]))
        assert torch.isfinite(lt).all()
        _close(lt, lj, "float32", f"decode bundle token {i}")
        _close(ct["k"], cj["k"], "float32", "decode bundle cache")
    assert int(ct["len"]) == 10


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-moe-a2.7b"])
def test_launcher_mode_lm(arch, monkeypatch, capsys):
    """``--mode lm --device cpu --batch 2 --gen-len 4`` exits 0 with
    finite logits; run again with the smoke config in fp32, its greedy
    tokens equal those of ``repro``'s ``prefill``/``decode_step`` on its
    parameters."""
    argv = ["--mode", "lm", "--arch", arch, "--device", "cpu", "--batch",
            "2", "--gen-len", "4"]
    runs = []
    plain_generate, plain_smoke = t_serve.lm_generate, t_train.smoke_spec
    monkeypatch.setattr(t_serve, "lm_generate",
                        lambda *a, **k: runs.append(plain_generate(*a, **k))
                        or runs[-1])
    for dtype in ("bfloat16", "float32"):
        monkeypatch.setattr(
            t_train, "smoke_spec", lambda spec, dtype=dtype:
            dataclasses.replace(plain_smoke(spec), model_cfg=dataclasses.replace(
                plain_smoke(spec).model_cfg, dtype=dtype)))
        with pytest.raises(SystemExit) as ex:
            t_serve.main(argv)
        assert ex.value.code == 0
        assert runs[-1]["finite"] and runs[-1]["tokens"].shape == (2, 4)
    assert f"[serve-lm {arch}] 8 tokens" in capsys.readouterr().out
    res = runs[-1]
    cfg = dataclasses.replace(j_tf.tiny_like(
        j_registry.get_spec(arch).model_cfg), dtype="float32")
    jp = jax.tree.map(jnp.asarray, t_tf.tree_from_state(
        t_layers.dotted(res["params"])))
    logits, cache = J_PREFILL(jp, cfg, jnp.asarray(res["prompt"]), 20)
    out = [jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)]
    for _ in range(3):
        logits, cache = J_DECODE(jp, cfg, cache, out[-1])
        out.append(jnp.argmax(logits, -1).astype(jnp.int32))
    np.testing.assert_array_equal(res["tokens"],
                                  np.asarray(jnp.concatenate(out, 1)))
