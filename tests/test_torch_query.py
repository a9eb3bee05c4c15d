"""Query parity of the PyTorch port on indexes ``repro`` built.

``repro`` builds ER, R-MAT and grid indexes and saves them; the port
loads the files on the CPU. On every stage-2 route — the three kernel
routes (dense min-plus, fused, per-round ELL loop; the ``cuda`` backend
runs each kernel's plain version on CPU tensors) and the COO reference
— answers and round counts equal ``repro``'s on the same route, with
query chunking on and off. A port-saved index answers identically in
``repro``. Tolerance: bitwise.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import ISLabelIndex as JIndex
from repro.core import IndexConfig as JConfig
from repro.core.dispatch import CoreRelaxer as JRelaxer
from repro.graphs import generators as gen
from repro_torch.core import ISLabelIndex, label_intersect_mu, ref
from repro_torch.core.dispatch import CoreRelaxer

GRAPHS = {"er": lambda: gen.er_graph(260, 3.0, seed=11),
          "rmat": lambda: gen.rmat_graph(8, 8.0, seed=2),
          "grid": lambda: gen.grid_graph(14, seed=3)}
ROUTES = {"dense": dict(), "fused": dict(dense_threshold=2.0),
          "ell_loop": dict(dense_threshold=2.0, fused=False)}
Q = 40


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def saved(request, tmp_path_factory):
    n, src, dst, w = GRAPHS[request.param]()
    idx = JIndex.build(n, src, dst, w, JConfig(l_cap=128, label_chunk=64))
    assert idx.stats.n_core > 0          # stage 2 must actually run
    path = tmp_path_factory.mktemp(request.param)
    idx.save(path)
    rng = np.random.default_rng(7)
    s = rng.integers(0, n, Q).astype(np.int32)
    t = rng.integers(0, n, Q).astype(np.int32)
    return idx, ISLabelIndex.load(path, device="cpu"), path, s, t, (
        n, src, dst, w)


def _pin(j_idx, t_idx, route):
    """Pin both engines to one kernel route, as tests/test_dispatch.py
    does for ``repro``."""
    je, te = j_idx.engine, t_idx.engine
    je.relaxer = JRelaxer(je.ce_src, je.ce_dst, je.ce_w, je.n_core,
                          **ROUTES[route])
    te.relaxer = CoreRelaxer(te.relaxer.ce_src, te.relaxer.ce_dst,
                             te.relaxer.ce_w, te.n_core, device="cpu",
                             **ROUTES[route])
    assert te.relaxer.mode == route


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routes_match_repro(saved, route):
    j_idx, t_idx, _, s, t, _ = saved
    _pin(j_idx, t_idx, route)
    want = j_idx.engine.query(s, t, backend="interpret")
    got = t_idx.engine.query(s, t, backend="cuda")
    _eq(got, want)
    assert t_idx.engine._last_rounds == j_idx.engine._last_rounds
    # query_chunk on: 40 queries in chunks of 16 -> a padded tail
    got_c = t_idx.engine.query(s, t, backend="cuda", query_chunk=16)
    _eq(got_c, want)


def test_reference_route_and_dijkstra(saved):
    j_idx, t_idx, _, s, t, (n, src, dst, w) = saved
    want = j_idx.engine.query(s, t, backend="reference")
    for chunk in (0, 16):
        got = t_idx.engine.query(s, t, backend="reference", query_chunk=chunk)
        _eq(got, want)
    j_idx.engine.query(s, t, backend="reference")
    t_idx.engine.query(s, t, backend="reference")
    assert t_idx.engine._last_rounds == j_idx.engine._last_rounds
    oracle = ref.dijkstra_oracle(n, src, dst, w, s)[np.arange(Q), t]
    np.testing.assert_array_equal(t_idx.query_host(s, t),
                                  oracle.astype(np.float32))


def test_mu_only_meet_and_types(saved):
    j_idx, t_idx, _, s, t, _ = saved
    for backend in ("cuda", "reference"):
        _eq(t_idx.engine.query_mu_only(s, t, backend=backend),
            j_idx.engine.query_mu_only(s, t, backend="reference"))
    from repro.core import label_intersect_mu as j_mu
    je, te = j_idx.engine, t_idx.engine
    sl, tl = torch.from_numpy(s).long(), torch.from_numpy(t).long()
    got = label_intersect_mu(te.lbl_ids[sl], te.lbl_d[sl], te.lbl_ids[tl],
                             te.lbl_d[tl], t_idx.n)
    want = j_mu(je.lbl_ids[s], je.lbl_d[s], je.lbl_ids[t], je.lbl_d[t],
                j_idx.n, je.l_cap)
    for a, b in zip(got, want):
        _eq(a, b)
    np.testing.assert_array_equal(t_idx.query_types(s, t),
                                  j_idx.query_types(s, t))


def test_serving_entry_points(saved):
    """``batch_fn`` / ``mu_batch_fn`` answer as ``query`` /
    ``query_mu_only`` and return the round count without a host read;
    ``warmup`` runs one batch per (path, size)."""
    j_idx, t_idx, _, s, t, _ = saved
    eng = t_idx.engine
    ans, rounds = eng.batch_fn("cuda")(s, t)
    _eq(ans, j_idx.engine.query(s, t, backend="reference"))
    eng.query(s, t, backend="cuda")
    assert int(rounds) == eng._last_rounds
    _eq(eng.mu_batch_fn("cuda")(s, t),
        j_idx.engine.query_mu_only(s, t, backend="reference"))
    assert eng.batch_fn("cuda") is eng.batch_fn("cuda")
    timings = eng.warmup([4, 8], backend="cuda")
    assert sorted(timings) == [("full", 4), ("full", 8), ("mu", 4),
                               ("mu", 8)]


def test_port_saved_index_answers_in_repro(saved, tmp_path):
    j_idx, t_idx, _, s, t, _ = saved
    t_idx.save(tmp_path)
    back = JIndex.load(tmp_path)
    np.testing.assert_array_equal(back.query_host(s, t),
                                  j_idx.query_host(s, t))
    again = ISLabelIndex.load(tmp_path, device="cpu")
    np.testing.assert_array_equal(again.query_host(s, t),
                                  t_idx.query_host(s, t))


def test_backend_names_cross_between_packages(saved, tmp_path):
    """``repro``'s 'pallas' / 'interpret' query backends map to 'auto'
    on load, and the port saves 'cuda' back as 'auto' (``repro`` raises
    on a backend name it does not know)."""
    _, _, path, s, t, _ = saved
    meta = json.loads((path / "meta.json").read_text())
    meta["cfg"]["query_backend"] = "pallas"
    with np.load(path / "index.npz") as z:
        arrays = dict(z)
    idx = ISLabelIndex.from_arrays(meta, arrays, device="cpu")
    assert idx.cfg.query_backend == "auto"
    assert idx.engine.query(s[:4], t[:4]).shape == (4,)
    idx.cfg = dataclasses.replace(idx.cfg, query_backend="cuda")
    idx.save(tmp_path)
    saved_meta = json.loads((tmp_path / "meta.json").read_text())
    assert saved_meta["cfg"]["query_backend"] == "auto"
