"""Batched shortest paths (§8.1) of the PyTorch port against ``repro``.

``repro`` builds ER, R-MAT and grid indexes and saves them; the port
loads the files on the CPU. Every ``PathBatch`` field (dist, verts,
weights, lens, ok, rounds) equals ``repro``'s
``path_batch_fn(hop_cap, "reference")`` on each of the three kernel
routes (the ``cuda`` backend runs each kernel's plain version on CPU
tensors) and the COO reference route, at hop_cap 4 (overflow), 16 and
128. Then: escalation in ``paths()``, s == t, disconnected pairs, paths
wholly inside the core, the host oracle's vertex lists, the validation
gate, and the ``path.batches`` counter per tier. Tolerance: bitwise.
"""
import numpy as np
import pytest

from repro.core import ISLabelIndex as JIndex
from repro.core import IndexConfig as JConfig
from repro.graphs import generators as gen
from repro.paths import check_path_batch as j_check_path_batch
from repro_torch.core import ISLabelIndex
from repro_torch.core.dispatch import CoreRelaxer
from repro_torch.obs import REGISTRY
from repro_torch.paths import (DEFAULT_HOP_CAP, PathEngine, check_path_batch,
                               check_vertex_path, edge_weight_map)
from test_torch_query import GRAPHS, ROUTES

Q = 40
HOP_CAPS = (4, 16, 128)
FIELDS = ("dist", "verts", "weights", "lens", "ok", "rounds")


def _load(tmp_path_factory, name, n, src, dst, w, **cfg):
    j_idx = JIndex.build(n, src, dst, w,
                         JConfig(l_cap=128, label_chunk=64, **cfg))
    path = tmp_path_factory.mktemp(name)
    j_idx.save(path)
    return j_idx, ISLabelIndex.load(path, device="cpu")


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request, tmp_path_factory):
    n, src, dst, w = GRAPHS[request.param]()
    j_idx, t_idx = _load(tmp_path_factory, request.param, n, src, dst, w)
    assert j_idx.stats.n_core > 0
    rng = np.random.default_rng(17)
    s = rng.integers(0, n, Q).astype(np.int32)
    t = rng.integers(0, n, Q).astype(np.int32)
    return {"j": j_idx, "t": t_idx, "s": s, "t_": t, "graph": (n, src, dst, w),
            "edges": edge_weight_map(src, dst, w), "want": {}}


def _want(pair, hc, s=None, t=None):
    """``repro``'s reference batch (memoized per hop_cap for the
    fixture's pairs)."""
    fn = pair["j"].path_engine().path_batch_fn(hc, "reference")
    if s is not None:
        return fn(s, t)
    if hc not in pair["want"]:
        pair["want"][hc] = fn(pair["s"], pair["t_"])
    return pair["want"][hc]


def _engine(t_idx, route):
    """A port engine over the index with the core relaxer pinned to one
    kernel route (as ``test_torch_query._pin``), and its backend."""
    if route == "reference":
        return PathEngine.from_index(t_idx), "reference"
    rel = t_idx.engine.relaxer
    pinned = CoreRelaxer(rel.ce_src, rel.ce_dst, rel.ce_w, rel.n_core,
                         device="cpu", **ROUTES[route])
    assert pinned.mode == route
    eng = PathEngine.from_index(t_idx)
    eng.relaxer = pinned
    return eng, "cuda"


def _same_batch(got, want):
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("hc", HOP_CAPS)
@pytest.mark.parametrize("route", sorted(ROUTES) + ["reference"])
def test_path_batch_matches_repro(pair, route, hc):
    eng, backend = _engine(pair["t"], route)
    got = eng.path_batch_fn(hc, backend)(pair["s"], pair["t_"])
    want = _want(pair, hc)
    _same_batch(got, want)
    if hc == 4:
        assert not got.ok.all()            # overflow is exercised
    if hc == 128:
        assert got.ok.all()


def test_escalation_matches_repro(pair):
    s, t = pair["s"], pair["t_"]
    d_j, p_j, ok_j = pair["j"].shortest_paths(s, t, hop_cap=4)
    d_t, p_t, ok_t = pair["t"].shortest_paths(s, t, hop_cap=4)
    np.testing.assert_array_equal(d_t, np.asarray(d_j))
    np.testing.assert_array_equal(ok_t, ok_j)
    assert p_t == p_j and ok_t.all()
    # hop_cap 4 overflowed, so paths() escalated
    assert not pair["t"].path_engine().path_batch_fn(4)(s, t).ok.all()


def test_s_equals_t(pair):
    s = np.asarray([5, 17, 0, pair["graph"][0] - 1], np.int32)
    got = pair["t"].path_engine().path_batch_fn(64, "cuda")(s, s)
    _same_batch(got, _want(pair, 64, s, s))
    assert (got.dist.numpy() == 0).all() and (got.lens.numpy() == 1).all()
    np.testing.assert_array_equal(got.verts.numpy()[:, 0], s)


def test_disconnected_pairs(tmp_path_factory):
    # sparse ER has small components: some pairs are unreachable
    n, src, dst, w = gen.er_graph(300, 1.5, seed=7)
    j_idx, t_idx = _load(tmp_path_factory, "disconnected", n, src, dst, w)
    rng = np.random.default_rng(0)
    s = rng.integers(0, n, 64).astype(np.int32)
    t = rng.integers(0, n, 64).astype(np.int32)
    got = t_idx.path_engine().path_batch_fn(64, "cuda")(s, t)
    _same_batch(got, j_idx.path_engine().path_batch_fn(64, "reference")(s, t))
    fin = np.isfinite(got.dist.numpy())
    assert (~fin).any()
    np.testing.assert_array_equal(got.lens.numpy() == 0, ~fin)


def test_paths_inside_the_core(pair):
    core = pair["j"].core_ids
    s = core[:8].astype(np.int32)
    t = core[-8:][::-1].copy().astype(np.int32)
    got = pair["t"].path_engine().path_batch_fn(128, "cuda")(s, t)
    _same_batch(got, _want(pair, 128, s, t))
    rep = check_path_batch(pair["edges"], s, t, got)
    assert rep["violations"] == [] and rep["overflowed"] == 0
    assert (got.lens.numpy()[s != t] >= 2).all()


def test_shortest_path_host_oracle(pair):
    j_idx, t_idx = pair["j"], pair["t"]
    for a, b in zip(pair["s"][:16], pair["t_"][:16]):
        d, path = t_idx.shortest_path(int(a), int(b))
        assert (d, path) == j_idx.shortest_path(int(a), int(b))
        assert check_vertex_path(pair["edges"], int(a), int(b), d, path) == []
    # the host caches are reused between calls
    labels, adj = t_idx._label_host(), t_idx._core_adjacency()
    t_idx.shortest_path(int(pair["s"][0]), int(pair["t_"][0]))
    assert t_idx._label_host() is labels and t_idx._core_adjacency() is adj


def test_validation_gate(pair):
    """Clean on the port's batch; on a corrupted batch the port's gate
    reports what ``repro``'s does."""
    s, t = pair["s"], pair["t_"]
    got = pair["t"].path_engine().path_batch_fn(128, "cuda")(s, t)
    rep = check_path_batch(pair["edges"], s, t, got)
    assert rep == {"checked": Q, "overflowed": 0, "violations": []}
    host = got._replace(**{f: getattr(got, f).numpy().copy() for f in FIELDS})
    host.verts[0, 1] = (host.verts[0, 1] + 1) % pair["graph"][0]
    host.weights[1, 0] += 1.0
    host.dist[2] += 1.0
    rep = check_path_batch(pair["edges"], s, t, host)
    assert rep["violations"]
    assert rep == j_check_path_batch(pair["edges"], s, t, host)


def test_path_batches_counter_and_warmup(pair):
    eng = pair["t"].path_engine()
    counter = REGISTRY.counter("path.batches")
    before = {hc: counter.value(hop_cap=str(hc)) for hc in (16, 32)}
    eng.path_batch_fn(16)(pair["s"], pair["t_"])
    eng.path_batch_fn(16)(pair["s"], pair["t_"])
    eng.path_batch_fn(32)(pair["s"], pair["t_"])
    assert counter.value(hop_cap="16") == before[16] + 2
    assert counter.value(hop_cap="32") == before[32] + 1
    assert eng.path_batch_fn(16) is eng.path_batch_fn(16)
    timings = eng.warmup([4, 8], hop_caps=(16, DEFAULT_HOP_CAP))
    assert sorted(timings) == [(4, 16), (4, DEFAULT_HOP_CAP), (8, 16),
                               (8, DEFAULT_HOP_CAP)]
