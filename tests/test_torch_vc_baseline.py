"""The VC-Index baseline (paper Table 8 comparator) in the PyTorch port
against ``repro`` on the CPU (``core/vc_baseline.py``).

With ``repro``'s MIS permutations injected the one-level (k=2)
hierarchy, its labels and the answers equal ``repro``'s bitwise; with
the port's own permutations the hierarchy differs but the answers are
still ``repro``'s and Dijkstra's exactly (integer-valued weights). The
last two cases are twins of ``tests/test_vc_baseline.py``.
"""
import jax
import numpy as np
import pytest

from repro.core import IndexConfig as JConfig
from repro.core.vc_baseline import build_vc_index as j_build_vc_index
from repro.core.vc_baseline import vc_index_config as j_vc_index_config
from repro.graphs import generators as gen
from repro_torch.core import ISLabelIndex, IndexConfig, ref
from repro_torch.core.vc_baseline import build_vc_index, vc_index_config

CFG = dict(l_cap=512, label_chunk=256)
HIER_FIELDS = ("level", "up_ids", "up_w", "up_via", "core_src", "core_dst",
               "core_w", "core_via")


def jax_perms(seed, n):
    """The permutations ``repro``'s device builder draws, level by level."""
    rng = jax.random.PRNGKey(seed)
    while True:
        rng, sub = jax.random.split(rng)
        yield np.asarray(jax.random.permutation(sub, n))


@pytest.fixture(scope="module")
def exact_graph():
    """``test_vc_baseline_exact``'s graph, ``repro``'s VC index on it and
    100 seeded pairs with ``repro``'s answers."""
    n, src, dst, w = gen.rmat_graph(9, avg_deg=6.0, seed=3)
    want = j_build_vc_index(n, src, dst, w, JConfig(**CFG))
    r = np.random.default_rng(0)
    s = r.integers(0, n, 100).astype(np.int32)
    t = r.integers(0, n, 100).astype(np.int32)
    return (n, src, dst, w), want, s, t, np.asarray(want.query_host(s, t))


def test_config_matches_repro():
    for base in (IndexConfig(), IndexConfig(**CFG, k_force=5, d_cap=8)):
        got = vc_index_config(base)
        want = j_vc_index_config(JConfig(**{
            k: getattr(base, k) for k in JConfig.__dataclass_fields__}))
        assert (got.k_force, got.d_cap) == (2, 64)
        assert {k: getattr(got, k) for k in JConfig.__dataclass_fields__} \
            == want.__dict__


def test_injected_permutations_give_repro_index_bitwise(exact_graph):
    (n, src, dst, w), want, s, t, answers = exact_graph
    got = build_vc_index(n, src, dst, w, IndexConfig(**CFG), device="cpu",
                         perms=jax_perms(0, n))
    assert got.k == want.k == 2
    pairs = [(f, getattr(got, f), getattr(want, f)) for f in HIER_FIELDS]
    pairs += [(f, getattr(got, f).numpy(), np.asarray(getattr(want, f)))
              for f in ("lbl_ids", "lbl_d", "lbl_pred")]
    for f, a, b in pairs:
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    for f in ("mis_rounds", "level_sizes", "graph_sizes", "n_core", "m_core",
              "label_entries"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    np.testing.assert_array_equal(got.query(s, t).numpy(), answers)


def test_own_rng_answers_equal_repro_bitwise(exact_graph):
    (n, src, dst, w), want, s, t, answers = exact_graph
    got = build_vc_index(n, src, dst, w, IndexConfig(**CFG), device="cpu")
    assert got.k == 2
    np.testing.assert_array_equal(got.query(s, t).numpy(), answers)
    np.testing.assert_array_equal(got.query_host(s, t), answers)


def test_vc_baseline_exact():
    """Twin of ``tests/test_vc_baseline.py::test_vc_baseline_exact``."""
    n, src, dst, w = gen.rmat_graph(9, avg_deg=6.0, seed=3)
    idx = build_vc_index(n, src, dst, w, IndexConfig(**CFG), device="cpu")
    assert idx.k == 2
    r = np.random.default_rng(0)
    s = r.integers(0, n, 100).astype(np.int32)
    t = r.integers(0, n, 100).astype(np.int32)
    got = idx.query_host(s, t)
    want = ref.dijkstra_oracle(n, src, dst, w, s)[np.arange(100), t]
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_array_equal(got[fin], want[fin].astype(np.float32))


def test_hierarchy_beats_one_level():
    """Twin of ``tests/test_vc_baseline.py::
    test_hierarchy_beats_one_level``: the multi-level hierarchy leaves a
    (much) smaller core than the one-level vertex-cover scheme, and both
    are exact on the same queries."""
    n, src, dst, w = gen.rmat_graph(10, avg_deg=6.0, seed=5)
    cfg = IndexConfig(l_cap=512, label_chunk=512)
    multi = ISLabelIndex.build(n, src, dst, w, cfg, device="cpu")
    one = build_vc_index(n, src, dst, w, cfg, device="cpu")
    assert multi.k > 2 and one.k == 2
    assert multi.stats.n_core < one.stats.n_core
    r = np.random.default_rng(1)
    s = r.integers(0, n, 50).astype(np.int32)
    t = r.integers(0, n, 50).astype(np.int32)
    np.testing.assert_array_equal(multi.query(s, t).numpy(),
                                  one.query(s, t).numpy())
    np.testing.assert_array_equal(multi.query_host(s, t),
                                  one.query_host(s, t))
