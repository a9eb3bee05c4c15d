"""Construction parity of the PyTorch port against ``repro``.

With JAX's MIS permutations injected (one per level, split from
``PRNGKey(cfg.seed)`` exactly as ``repro``'s builder does) the port's
hierarchy and labels equal ``repro``'s bitwise, MIS round counts
included, from either builder (``builder="device"`` or ``"host"``).
With the port's own permutations the hierarchy differs, but the answers
still equal ``repro``'s and Dijkstra's exactly (the generators' weights
are integer-valued).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import ISLabelIndex as JIndex
from repro.core import IndexConfig as JConfig
from repro.core.hierarchy import build_hierarchy_host as j_build_host
from repro.core.labeling import build_labels as j_build_labels
from repro.core.mis import independent_set as j_independent_set
from repro.graphs import generators as gen
from repro_torch.core import ISLabelIndex, IndexConfig, build_hierarchy, ref
from repro_torch.core.hierarchy import (build_hierarchy_device,
                                        build_hierarchy_host)
from repro_torch.core.labeling import build_labels
from repro_torch.core.mis import MISState, lex_less, mis_key_words
from repro_torch.graphs import generators as tgen

CFG = dict(l_cap=128, label_chunk=64)
GRAPHS = [("er", lambda g: g.er_graph(300, 3.0, seed=1)),
          ("rmat", lambda g: g.rmat_graph(8, 8.0, seed=2)),
          ("grid", lambda g: g.grid_graph(16, seed=3))]


def jax_perms(seed, n):
    """The permutations ``repro``'s device builder draws, level by level."""
    rng = jax.random.PRNGKey(seed)
    while True:
        rng, sub = jax.random.split(rng)
        yield np.asarray(jax.random.permutation(sub, n))


@pytest.mark.parametrize("name,mk", GRAPHS)
def test_generators_identical(name, mk):
    for a, b in zip(mk(gen), mk(tgen)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,mk", GRAPHS)
def test_injected_permutations_give_repro_index_bitwise(name, mk):
    n, src, dst, w = mk(gen)
    want = JIndex.build(n, src, dst, w, JConfig(**CFG))
    got = ISLabelIndex.build(n, src, dst, w, IndexConfig(**CFG),
                             device="cpu", perms=jax_perms(0, n))
    assert got.k == want.k
    pairs = [(f, getattr(got, f), getattr(want, f))
             for f in ("level", "up_ids", "up_w", "up_via", "core_src",
                       "core_dst", "core_w", "core_via")]
    pairs += [(f, getattr(got, f).numpy(), np.asarray(getattr(want, f)))
              for f in ("lbl_ids", "lbl_d", "lbl_pred")]
    for f, a, b in pairs:
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    for f in ("mis_rounds", "level_sizes", "graph_sizes", "n_core", "m_core",
              "label_entries", "peel_iters"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    # one blocking read per peeled level (the MIS fits its first guess)
    assert got.stats.peel_loop_syncs == got.stats.peel_iters


@pytest.mark.parametrize("name,mk", GRAPHS)
def test_own_rng_answers_equal_repro_and_dijkstra(name, mk):
    n, src, dst, w = mk(gen)
    rng = np.random.default_rng(5)
    s = rng.integers(0, n, 80).astype(np.int32)
    t = rng.integers(0, n, 80).astype(np.int32)
    want = JIndex.build(n, src, dst, w, JConfig(**CFG)).query_host(s, t)
    idx = ISLabelIndex.build(n, src, dst, w, IndexConfig(**CFG), device="cpu")
    oracle = ref.dijkstra_oracle(n, src, dst, w, s)[np.arange(80), t]
    for backend in ("cuda", "reference"):
        got = idx.engine.query(s, t, backend=backend).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle.astype(np.float32))


def test_e_cap_overflow_raises_actionable():
    n, src, dst, w = gen.er_graph(300, 6.0, seed=3)
    with pytest.raises(RuntimeError,
                       match=r"edge capacity overflow at level \d+.*"
                             r"e_cap_factor"):
        build_hierarchy(n, src, dst, w,
                        IndexConfig(e_cap_factor=1.2, aug_cap_factor=8.0),
                        device="cpu")


def test_aug_cap_overflow_raises_actionable():
    n, src, dst, w = gen.er_graph(300, 6.0, seed=3)
    with pytest.raises(RuntimeError,
                       match=r"augmentation buffer overflow at level \d+"
                             r".*aug_cap_factor"):
        build_hierarchy(n, src, dst, w,
                        IndexConfig(e_cap_factor=8.0, aug_cap_factor=0.2),
                        device="cpu")


def test_l_cap_overflow_raises_actionable():
    n, src, dst, w = gen.caveman_graph(6, 10, seed=7)
    cfg = IndexConfig(l_cap=2, label_chunk=32, e_cap_factor=8.0,
                      aug_cap_factor=4.0, sync_every=64)
    h = build_hierarchy(n, src, dst, w, cfg, device="cpu")
    with pytest.raises(RuntimeError,
                       match=r"label capacity overflow at level \d+.*"
                             r"l_cap \(currently 2\)"):
        build_labels(h, cfg, device="cpu")


HIER_FIELDS = ("level", "up_ids", "up_w", "up_via", "core_src", "core_dst",
               "core_w", "core_via")


@pytest.mark.parametrize("builder,exc", [("host", None),
                                         ("gpu", ValueError)])
def test_builder_choice(builder, exc):
    """"host" builds the device builder's hierarchy from the same seed;
    an unknown builder raises."""
    n, src, dst, w = gen.er_graph(64, 2.0, seed=0)
    if exc is not None:
        with pytest.raises(exc, match="builder"):
            build_hierarchy(n, src, dst, w, IndexConfig(builder=builder),
                            device="cpu")
        return
    got = build_hierarchy(n, src, dst, w, IndexConfig(builder=builder),
                          device="cpu")
    want = build_hierarchy(n, src, dst, w, IndexConfig(), device="cpu")
    assert got.k == want.k
    for f in HIER_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("name,mk", GRAPHS)
def test_host_builder_matches_repro_and_device_builder(name, mk):
    """The host loop with JAX's permutations equals ``repro``'s host
    loop and the port's device builder, bitwise: hierarchy, per-level
    records and labels. It reads once per MIS round and several times
    per level; the device builder once per level."""
    n, src, dst, w = mk(gen)
    cfg = IndexConfig(**CFG)
    host = build_hierarchy_host(n, src, dst, w, cfg, "cpu",
                                perms=jax_perms(0, n))
    dev = build_hierarchy_device(n, src, dst, w, cfg, "cpu",
                                 perms=jax_perms(0, n))
    want = j_build_host(n, src, dst, w, JConfig(**CFG))
    for f in HIER_FIELDS:
        a, b = getattr(host, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
        np.testing.assert_array_equal(a, getattr(dev, f), f)
    for f in ("k", "level_sizes", "graph_sizes", "mis_rounds", "peel_iters"):
        assert getattr(host, f) == getattr(want, f) == getattr(dev, f), f
    assert dev.host_syncs == dev.peel_iters < host.host_syncs
    got = build_labels(host, cfg, "cpu")
    for a, b, c in zip(got, build_labels(dev, cfg, "cpu"),
                       j_build_labels(want, JConfig(**CFG))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_lex_less_matches_packed_key_order():
    rng = np.random.default_rng(0)
    n, d_cap = 2 ** 31 - 2, 16
    deg = rng.integers(0, d_cap + 2, 500).astype(np.int32)
    perm = rng.integers(0, n, 500).astype(np.int64)
    hi, lo = mis_key_words(torch.from_numpy(deg), torch.from_numpy(perm),
                           d_cap)
    packed = deg.astype(object) * (n + 1) + perm.astype(object)
    a = rng.integers(0, 500, 4000)
    b = rng.integers(0, 500, 4000)
    got = lex_less(hi[a], lo[a], hi[b], lo[b]).numpy()
    np.testing.assert_array_equal(got, (packed[a] < packed[b]).astype(bool))


@pytest.mark.parametrize("seed", [0, 3])
def test_independent_set_matches_repro(seed):
    """Same IS and round count as ``repro``'s while_loop however many
    rounds run: rounds past the fixed point are uncounted no-ops."""
    n, src, dst, w = gen.er_graph(120, 3.0, seed=seed)
    valid = src < n
    key = jax.random.PRNGKey(seed)
    j_in, j_rounds = j_independent_set(
        jax.numpy.asarray(src), jax.numpy.asarray(dst),
        jax.numpy.asarray(valid), jax.numpy.ones(n, bool), key, n, 8)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, n)))
    st = MISState.start(torch.from_numpy(src), torch.from_numpy(dst),
                        torch.from_numpy(valid), torch.ones(n, dtype=bool),
                        perm, n, 8)
    st.advance(int(j_rounds) + 5)
    np.testing.assert_array_equal(st.in_is.numpy(), np.asarray(j_in))
    assert int(st.rounds) == int(j_rounds)
    assert not bool(st.pool_left())
