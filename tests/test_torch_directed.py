"""Directed IS-LABEL (§8.2) of the PyTorch port
(``repro_torch.core.directed``) against ``repro.core.directed``.

On ``tests/test_directed.py``'s three seeded digraphs (n = 180, e =
700), with ``repro``'s MIS permutations injected: ``level``, ``k``, both
label families, the up-adjacencies and the core arrays bitwise, then
the answers. With the port's own RNG the hierarchy may differ, but the
answers equal ``repro``'s and Dijkstra's. Then the asymmetry and
reachability cases, ``shortest_path`` vertex lists equal to ``repro``'s
on 16 pairs (each path a chain of real edges whose weights sum to the
distance), endpoint ids mapped as ``repro`` maps them, and the relax
rounds capped at n_core. Tolerance: bitwise (integral weights).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import IndexConfig as JConfig
from repro.core.directed import DiISLabelIndex as JDiIndex
from repro_torch.core import IndexConfig, ref
from repro_torch.core.directed import DiISLabelIndex
from repro_torch.paths import check_vertex_path, edge_weight_map
from test_directed import _digraph
from test_torch_build import jax_perms

N, E = 180, 700
CFG = dict(l_cap=256, label_chunk=128)
SEEDS = [0, 1, 2]


@pytest.fixture(scope="module", params=SEEDS)
def built(request):
    seed = request.param
    src, dst, w = _digraph(N, E, seed)
    j_idx = JDiIndex.build(N, src, dst, w, JConfig(**CFG))
    idx = DiISLabelIndex.build(N, src, dst, w, IndexConfig(**CFG),
                               device="cpu", perms=jax_perms(0, N))
    rng = np.random.default_rng(seed + 100)
    s = rng.integers(0, N, 120).astype(np.int32)
    t = rng.integers(0, N, 120).astype(np.int32)
    return {"seed": seed, "graph": (src, dst, w), "j_idx": j_idx,
            "idx": idx, "s": s, "t": t}


def test_injected_permutations_give_repro_index_bitwise(built):
    j_idx, idx = built["j_idx"], built["idx"]
    assert (idx.k, idx.n_core) == (j_idx.k, j_idx.n_core)
    np.testing.assert_array_equal(idx.level, j_idx.level)
    np.testing.assert_array_equal(idx.core_pos, j_idx.core_pos)
    for fam in ("out_lbl", "in_lbl"):
        for a, b in zip(getattr(idx, fam), getattr(j_idx, fam)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=fam)
    for fam in ("up_out", "up_in", "core_host"):
        for a, b in zip(getattr(idx, fam), getattr(j_idx, fam)):
            assert a.dtype == b.dtype, fam
            np.testing.assert_array_equal(a, b, err_msg=fam)
    for a, b in zip(idx.core_edges, j_idx.core_edges):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        idx.query_host(built["s"], built["t"]),
        np.asarray(j_idx.query_host(built["s"], built["t"])))


def test_own_rng_answers_equal_repro_and_dijkstra(built):
    src, dst, w = built["graph"]
    s, t = built["s"], built["t"]
    idx = DiISLabelIndex.build(N, src, dst, w, IndexConfig(**CFG),
                               device="cpu")
    got = idx.query_host(s, t)
    np.testing.assert_array_equal(
        got, np.asarray(built["j_idx"].query_host(s, t)))
    want = ref.dijkstra_oracle(N, src, dst, w, s)[np.arange(len(s)), t]
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(idx.reachable(s, t), np.isfinite(got))


def test_shortest_path_equal_repro(built):
    """16 pairs: the same (distance, vertex list) as ``repro``'s host
    oracle, and every reachable path a chain of real directed edges."""
    j_idx, idx = built["j_idx"], built["idx"]
    edges = edge_weight_map(*built["graph"])
    reached = 0
    for i in range(16):
        s, t = int(built["s"][i]), int(built["t"][i])
        got = idx.shortest_path(s, t)
        assert got == j_idx.shortest_path(s, t), (s, t)
        assert check_vertex_path(edges, s, t, got[0], got[1]) == []
        reached += bool(got[1])
    assert reached >= 8


def test_endpoint_ids_map_as_repro(built):
    """Out-of-range ids read rows as ``repro``'s jnp gathers do; tensor
    endpoints stay where they lie."""
    j_idx, idx = built["j_idx"], built["idx"]
    s = np.array([0, N, N + 3, -1, -2, -(N + 5), 7], np.int32)
    t = np.array([5, 3, N, 9, -1, 4, -(N + 5)], np.int32)
    np.testing.assert_array_equal(idx.query_host(s, t),
                                  np.asarray(j_idx.query_host(s, t)))
    np.testing.assert_array_equal(
        idx.query_host(torch.as_tensor(s), torch.as_tensor(t)),
        idx.query_host(s, t))


def test_relax_rounds_capped_at_n_core(built):
    idx = built["idx"]
    idx.query(built["s"], built["t"])
    fwd, bwd = (int(r) for r in idx._last_rounds)
    assert 1 <= fwd <= idx.n_core and 1 <= bwd <= idx.n_core


def test_asymmetry_preserved():
    """dist(s->t) != dist(t->s) must be answered per direction."""
    src = np.asarray([0, 1, 2], np.int32)
    dst = np.asarray([1, 2, 0], np.int32)
    w = np.asarray([1.0, 2.0, 4.0], np.float32)
    cfg = dict(l_cap=16, label_chunk=8)
    idx = DiISLabelIndex.build(3, src, dst, w, IndexConfig(**cfg),
                               device="cpu")
    j_idx = JDiIndex.build(3, src, dst, w, JConfig(**cfg))
    assert float(idx.query_host([0], [1])[0]) == 1.0
    assert float(idx.query_host([1], [0])[0]) == 6.0
    assert idx.shortest_path(1, 0) == j_idx.shortest_path(1, 0) == \
        (6.0, [1, 2, 0])


def test_reachability():
    """Directed IS-LABEL answers reachability (paper conclusion)."""
    src = np.asarray([0, 1, 5, 6, 2], np.int32)
    dst = np.asarray([1, 2, 6, 7, 5], np.int32)
    w = np.ones(5, np.float32)
    idx = DiISLabelIndex.build(8, src, dst, w,
                               IndexConfig(l_cap=16, label_chunk=8),
                               device="cpu")
    assert idx.reachable([0], [7])[0]            # 0->1->2->5->6->7
    assert not idx.reachable([7], [0])[0]
    assert idx.shortest_path(7, 0) == (float("inf"), [])
    assert idx.shortest_path(0, 7) == (5.0, [0, 1, 2, 5, 6, 7])


@pytest.mark.parametrize("seed,n", [(0, 20), (17, 33), (101, 48), (404, 60)])
def test_directed_property_vs_dijkstra(seed, n):
    """``tests/test_directed.py``'s property cases (d_cap = 8, so
    vertices of high degree stay in the core)."""
    src, dst, w = _digraph(n, n * 4, seed)
    idx = DiISLabelIndex.build(n, src, dst, w,
                               IndexConfig(l_cap=128, label_chunk=64,
                                           d_cap=8), device="cpu")
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, 30).astype(np.int32)
    t = rng.integers(0, n, 30).astype(np.int32)
    want = ref.dijkstra_oracle(n, src, dst, w, s)[np.arange(30), t]
    np.testing.assert_array_equal(idx.query_host(s, t),
                                  want.astype(np.float32))


def test_build_without_device_raises_off_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    src, dst, w = _digraph(20, 60, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiISLabelIndex.build(20, src, dst, w, IndexConfig(l_cap=16))
