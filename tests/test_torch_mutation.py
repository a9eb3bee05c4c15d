"""Host mutation (§8.3) of the PyTorch port against ``repro``.

``repro`` builds ER, R-MAT and grid indexes without one held-out vertex
u and saves them; the port loads the files on the CPU. Both apply one
sequence: insert u with its edges, delete a build-time core vertex and
a build-time vertex of the lowest level, then delete u. After each step
the port's label planes (``lbl_ids``, ``lbl_d``, ``lbl_pred``), core
arrays, ``level``, touched rows, answers, batched paths and host-oracle
paths equal ``repro``'s; the host caches are dropped or replaced, and a
compressed index is encoded again. Both rules are conservative: the
inserted vertex's distances are never shorter than Dijkstra's on the
full graph, and a deleted vertex's never shorter than on the graph
without it.
Tolerance: bitwise.
"""
import numpy as np
import pytest

from repro.core import ISLabelIndex as JIndex
from repro.core import IndexConfig as JConfig
from repro.core import labels as jlabels
from repro.graphs import generators as gen
from repro_torch.core import ISLabelIndex, ref
from repro_torch.core.index import apply_insert_host
from test_torch_query import GRAPHS

CORE = ("core_src", "core_dst", "core_w", "core_via", "core_ids",
        "core_pos_host", "level")
LABELS = ("lbl_ids", "lbl_d", "lbl_pred")
FIELDS = ("dist", "verts", "weights", "lens", "ok", "rounds")


def _holdout(n, src, dst):
    """The highest vertex id of degree 2..6 (so its insert adds both
    core edges and label pushes on most graphs)."""
    deg = np.bincount(src, minlength=n)
    return int(np.flatnonzero((deg >= 2) & (deg <= 6))[-1])


def _load(tmp_path_factory, name, n, src, dst, w, **cfg):
    j_idx = JIndex.build(n, src, dst, w,
                         JConfig(l_cap=128, label_chunk=64, **cfg))
    path = tmp_path_factory.mktemp(name)
    j_idx.save(path)
    return j_idx, ISLabelIndex.load(path, device="cpu")


def _ops(j_idx, u, src, dst, w):
    nbrs, ws = dst[src == u].tolist(), w[src == u].tolist()
    core = int(j_idx.core_ids[len(j_idx.core_ids) // 2])
    low = np.flatnonzero(j_idx.level == j_idx.level.min())
    low = int(low[low != u][3])
    return [("insert", u, nbrs, ws), ("delete", core), ("delete", low),
            ("delete", u)]


def _apply(idx, op):
    if op[0] == "insert":
        return idx.insert_vertex(*op[1:])
    return idx.delete_vertex(op[1])


def _same_state(j_idx, t_idx, s, t):
    for f in LABELS:
        np.testing.assert_array_equal(getattr(t_idx, f).numpy(),
                                      np.asarray(getattr(j_idx, f)), f)
    for f in CORE:
        a, b = getattr(t_idx, f), getattr(j_idx, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    np.testing.assert_array_equal(t_idx.query(s, t).numpy(),
                                  np.asarray(j_idx.query(s, t)))
    want = j_idx.path_engine().path_batch_fn(64, "reference")(s, t)
    for backend in ("cuda", "reference"):
        got = t_idx.path_engine().path_batch_fn(64, backend)(s, t)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)
    for a, b in zip(s[:8], t[:8]):
        assert (t_idx.shortest_path(int(a), int(b))
                == j_idx.shortest_path(int(a), int(b)))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_mutation_sequence_matches_repro(graph, tmp_path_factory):
    n, src, dst, w = GRAPHS[graph]()
    u = _holdout(n, src, dst)
    keep = (src != u) & (dst != u)
    j_idx, t_idx = _load(tmp_path_factory, graph, n, src[keep], dst[keep],
                         w[keep])
    rng = np.random.default_rng(5)
    s = rng.integers(0, n, 32).astype(np.int32)
    t = rng.integers(0, n, 32).astype(np.int32)
    s[:6] = u
    _same_state(j_idx, t_idx, s, t)          # warms every cache
    for op in _ops(j_idx, u, src, dst, w):
        old_labels = t_idx._label_host()
        old_engine = t_idx.engine
        touched = _apply(t_idx, op)
        np.testing.assert_array_equal(touched, _apply(j_idx, op))
        assert touched.dtype == np.int64
        # caches dropped; the host-label cache holds the new planes
        assert t_idx._core_adj is None and t_idx._paths is None
        assert t_idx.engine is not old_engine
        new_labels = t_idx._label_host()
        assert new_labels[0] is not old_labels[0]
        for a, b in zip(new_labels, (t_idx.lbl_ids, t_idx.lbl_d,
                                     t_idx.lbl_pred)):
            np.testing.assert_array_equal(a, b.numpy())
        diff = np.flatnonzero((old_labels[0] != new_labels[0]).any(1))
        assert set(diff.tolist()) <= set(touched.tolist())
        _same_state(j_idx, t_idx, s, t)
        if op[0] == "insert":
            # lazy insert never under-reports: each answer is the length
            # of a real path of the full graph
            want = ref.dijkstra_oracle(n, src, dst, w, [u])[0]
            got = t_idx.query_host(np.full(n, u, np.int32), np.arange(n))
            fin = np.isfinite(got)
            assert fin.sum() > 1 and np.isfinite(want[fin]).all()
            assert (got[fin] >= want[fin]).all()


def test_compressed_index_encoded_again(tmp_path_factory):
    n, src, dst, w = GRAPHS["er"]()
    u = _holdout(n, src, dst)
    keep = (src != u) & (dst != u)
    j_idx, t_idx = _load(tmp_path_factory, "compressed", n, src[keep],
                         dst[keep], w[keep], label_dtype="compressed")
    rng = np.random.default_rng(6)
    s = rng.integers(0, n, 32).astype(np.int32)
    t = rng.integers(0, n, 32).astype(np.int32)
    s[:6] = u
    for op in _ops(j_idx, u, src, dst, w)[::3]:      # insert u, delete u
        np.testing.assert_array_equal(_apply(t_idx, op), _apply(j_idx, op))
        eng = t_idx.engine
        assert eng.codec == "delta16"
        want = jlabels.encode_labels(np.asarray(j_idx.lbl_ids),
                                     np.asarray(j_idx.lbl_d), n)
        for a, b in zip((eng.enc_ids, eng.enc_base, eng.enc_d), want):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(t_idx.query(s, t).numpy(),
                                      np.asarray(j_idx.query(s, t)))
        np.testing.assert_array_equal(
            t_idx.engine.query_mu_only(s, t).numpy(),
            np.asarray(j_idx.engine.query_mu_only(s, t)))


def test_delete_is_conservative(tmp_path_factory):
    """A deleted build-time vertex: answers never shorter than the truth
    without it, and mostly equal (``tests/test_paths_updates.py``'s
    rule), and equal to ``repro``'s."""
    n, src, dst, w = gen.grid_graph(8, seed=13)
    j_idx, t_idx = _load(tmp_path_factory, "grid8", n, src, dst, w)
    u = 27
    np.testing.assert_array_equal(t_idx.delete_vertex(u),
                                  j_idx.delete_vertex(u))
    keep = (src != u) & (dst != u)
    rng = np.random.default_rng(13)
    s = rng.integers(0, n, 40).astype(np.int32)
    t = rng.integers(0, n, 40).astype(np.int32)
    mask = (s != u) & (t != u)
    got = t_idx.query_host(s[mask], t[mask])
    np.testing.assert_array_equal(got, j_idx.query_host(s[mask], t[mask]))
    want = ref.dijkstra_oracle(n, src[keep], dst[keep], w[keep],
                               s[mask])[np.arange(mask.sum()), t[mask]]
    fin = np.isfinite(got)
    assert (got[fin] >= want[fin]).all()
    cover = fin & np.isfinite(want)
    assert (got[cover] == want[cover]).mean() > 0.8


def test_insert_rejects_an_id_beyond_n(tmp_path_factory):
    n, src, dst, w = gen.er_graph(60, 3.0, seed=1)
    _, t_idx = _load(tmp_path_factory, "small", n, src, dst, w)
    ids, d, pred = t_idx._label_host()
    with pytest.raises(ValueError, match="grow n"):
        apply_insert_host(t_idx, ids, d, pred, n, [0], [1.0])
