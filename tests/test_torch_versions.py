"""Versioned copy-on-write mutation of the PyTorch port
(``repro_torch.serve.versions``) against ``repro.serve.versions``.

Both packages build ``er_graph(140, 2.4, seed=5)`` plus 16 spare ids
(the port with ``repro``'s MIS permutations injected, on the CPU) and
apply the same 3 epochs of 10 strict-domain ops (``_op_schedule`` of
``tests/test_mutation_diff.py``), ``repro`` on its reference backend.
Per epoch: ``(ans, rounds)`` of ``full_fn`` and ``mu_fn``, the touched
rows and every label array of the version, bitwise; the port's answers
equal a port rebuild from scratch with its own RNG. On the family's
``fused`` route (the kernels' plain versions on the CPU), on a forced
``ell_loop`` family and on the reference backend alike. Then the
strict-mode rejections and ``FamilyCapacityError`` where ``repro``
raises them, delete-then-reinsert, a compressed family against the fp32
one, the refcount lifecycle and ``version_family_gauges``.
Tolerance: bitwise.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import ISLabelIndex as JIndex
from repro.core import IndexConfig as JConfig
from repro.graphs import generators as gen
from repro.serve import FamilyCapacityError as JFamilyCapacityError
from repro.serve import MutationOp as JOp
from repro.serve import VersionManager as JManager
from repro_torch.core import ISLabelIndex, IndexConfig
from repro_torch.obs import MetricRegistry, version_family_gauges
from repro_torch.serve import (FamilyCapacityError, MutationOp,
                               VersionManager)
from repro_torch.serve import versions as tversions
from test_mutation_diff import _mirror_edges, _op_schedule
from test_torch_build import jax_perms

N_BASE, SPARES = 140, 16
N = N_BASE + SPARES
CFG = dict(l_cap=256, label_chunk=128)
EPOCHS, OPS_PER_EPOCH, Q = 3, 10, 64


def _ops(ops):
    return [MutationOp(*op) for op in ops]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def sweep():
    """Both managers through the same schedule; per epoch the versions,
    a query batch, and ``repro``'s reference answers, rounds and μ."""
    nb, src, dst, w = gen.er_graph(N_BASE, 2.4, seed=5)
    j_idx = JIndex.build(N, src, dst, w, JConfig(**CFG))
    idx = ISLabelIndex.build(N, src, dst, w, IndexConfig(**CFG),
                             device="cpu", perms=jax_perms(0, N))
    # 32-row blocks: the 157 label rows span 5 copy-on-write blocks
    j_mgr = JManager.from_index(j_idx, block_rows=32)
    mgr = VersionManager.from_index(idx, block_rows=32)
    sched = _op_schedule(np.random.default_rng(11), j_idx.core_ids,
                         range(N_BASE, N), EPOCHS, OPS_PER_EPOCH)
    q = np.random.default_rng(3)
    j_full, j_mu = j_mgr.family.full_fn("reference"), \
        j_mgr.family.mu_fn("reference")
    records, flat, live = [], [], set()
    for ops in sched:
        j_ver, ver = j_mgr.apply(ops), mgr.apply(_ops(ops))
        flat += list(ops)
        for op in ops:
            (live.add if op.kind == "insert" else live.discard)(op.u)
        ids = np.concatenate([np.arange(N_BASE),
                              np.asarray(sorted(live))]).astype(np.int32)
        s = ids[q.integers(0, len(ids), Q)]
        t = ids[q.integers(0, len(ids), Q)]
        ans, rounds = j_full(j_ver.state, s, t)
        records.append({
            "ops": ops, "j_version": j_ver, "version": ver, "s": s, "t": t,
            "ans": np.asarray(ans), "rounds": int(rounds),
            "mu": np.asarray(j_mu(j_ver.state, s, t)),
            "edges": _mirror_edges(src, dst, w, flat), "live": sorted(live)})
    return {"j_idx": j_idx, "idx": idx, "j_mgr": j_mgr, "mgr": mgr,
            "sched": sched, "records": records, "graph": (src, dst, w)}


def test_family_shapes_and_route_match_repro(sweep):
    fam, j_fam = sweep["mgr"].family, sweep["j_mgr"].family
    for attr in ("n", "core_cap", "edge_cap", "ell_width", "vp",
                 "max_rounds", "relax_mode", "codec", "d_dtype"):
        assert getattr(fam, attr) == getattr(j_fam, attr), attr
    assert fam.relax_mode == "fused"


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_full_and_mu_bitwise_per_epoch(sweep, backend):
    """``cuda`` on CPU tensors runs the fused route's plain versions
    over each version's sliced in-edges; ``reference`` the COO."""
    fam = sweep["mgr"].family
    full, mu = fam.full_fn(backend), fam.mu_fn(backend)
    for i, rec in enumerate(sweep["records"]):
        ans, rounds = full(rec["version"].state, rec["s"], rec["t"])
        np.testing.assert_array_equal(ans.numpy(), rec["ans"],
                                      err_msg=f"epoch {i}")
        assert int(rounds) == rec["rounds"], f"epoch {i}"
        np.testing.assert_array_equal(
            mu(rec["version"].state, rec["s"], rec["t"]).numpy(), rec["mu"])
    assert fam.cache_sizes(backend) == {"mu": 1, "full": 1}


def test_ell_loop_family_bitwise(sweep, monkeypatch):
    """A family over the budget takes ``ell_loop`` (each version carries
    a ``RelaxCSR``); the same schedule gives ``repro``'s answers and
    rounds."""
    monkeypatch.setattr(tversions, "FUSED_VMEM_BUDGET", 0)
    idx = ISLabelIndex.build(N, *sweep["graph"], IndexConfig(**CFG),
                             device="cpu", perms=jax_perms(0, N))
    mgr = VersionManager.from_index(idx)
    assert mgr.family.relax_mode == "ell_loop"
    assert isinstance(mgr.current.state.relax, tversions.RelaxCSR)
    full = mgr.family.full_fn("cuda")
    for i, rec in enumerate(sweep["records"]):
        ver = mgr.apply(_ops(rec["ops"]))
        ans, rounds = full(ver.state, rec["s"], rec["t"])
        np.testing.assert_array_equal(ans.numpy(), rec["ans"],
                                      err_msg=f"epoch {i}")
        assert int(rounds) == rec["rounds"], f"epoch {i}"


def test_touched_rows_and_labels_bitwise(sweep):
    for i, rec in enumerate(sweep["records"]):
        ver, j_ver = rec["version"], rec["j_version"]
        assert ver.vid == j_ver.vid == i + 1
        np.testing.assert_array_equal(ver.touched_rows, j_ver.touched_rows)
        for f in ("lbl_ids", "lbl_d", "lbl_pred"):
            np.testing.assert_array_equal(_np(getattr(ver.index, f)),
                                          _np(getattr(j_ver.index, f)),
                                          err_msg=f"epoch {i} {f}")
        for f in ("level", "core_ids", "core_src", "core_dst", "core_w",
                  "core_via"):
            np.testing.assert_array_equal(getattr(ver.index, f),
                                          getattr(j_ver.index, f))
        for a, b in zip(ver.store.arrays(), j_ver.store.arrays()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ver.mu_mask, j_ver.mu_mask)
        np.testing.assert_array_equal(_np(ver.state.core_slot),
                                      _np(j_ver.state.core_slot))
        for f in ("ce_src", "ce_dst", "ce_w"):
            np.testing.assert_array_equal(_np(getattr(ver.state, f)),
                                          _np(getattr(j_ver.state, f)))
        # the host oracle of the version answers as the family does
        np.testing.assert_array_equal(
            ver.index.query_host(rec["s"], rec["t"]), rec["ans"])


def test_answers_equal_port_rebuild_with_own_rng(sweep):
    fn = sweep["mgr"].family.full_fn("reference")
    for i, rec in enumerate(sweep["records"]):
        scratch = ISLabelIndex.build(N, *rec["edges"], IndexConfig(**CFG),
                                     device="cpu")
        ans, _ = fn(rec["version"].state, rec["s"], rec["t"])
        np.testing.assert_array_equal(
            ans.numpy(), scratch.query_host(rec["s"], rec["t"]),
            err_msg=f"epoch {i}")


def test_cow_blocks_shared_and_parent_untouched(sweep):
    """Each version shares with its parent every block its touched rows
    missed, and the parent's device planes keep their values (clone +
    row copy)."""
    mgr = sweep["mgr"]
    parent = mgr._versions[0]
    for rec in sweep["records"]:
        ver = rec["version"]
        dirty = {int(r) // ver.store.block_rows for r in ver.touched_rows}
        assert 0 < len(dirty) < ver.store.num_blocks == 5
        assert ver.store.shared_blocks(parent.store) == \
            ver.store.num_blocks - len(dirty)
        ids, d, pred = parent.store.arrays()
        np.testing.assert_array_equal(parent.index.lbl_ids.numpy(), ids)
        np.testing.assert_array_equal(parent.index.lbl_d.numpy(), d)
        np.testing.assert_array_equal(parent.index.lbl_pred.numpy(), pred)
        parent = ver


def test_strict_mode_rejections_match_repro(sweep):
    mgr, j_mgr, j_idx = sweep["mgr"], sweep["j_mgr"], sweep["j_idx"]
    leaf = int(np.flatnonzero(np.asarray(j_idx.level[:N_BASE]) < j_idx.k)[0])
    cases = [(("insert", N_BASE, (leaf,), (1.0,)), "non-core"),
             (("delete", leaf), "build-time"),
             (("rename", N_BASE), "unknown mutation kind")]
    for op, msg in cases:
        cur, j_cur = mgr.current, j_mgr.current
        with pytest.raises(ValueError, match=msg):
            j_mgr.apply([JOp(*op)])
        with pytest.raises(ValueError, match=msg):
            mgr.apply([MutationOp(*op)])
        # failed batches leave both managers untouched
        assert mgr.current is cur and j_mgr.current is j_cur


@pytest.mark.parametrize("kw,ops", [
    ({"core_headroom": 1}, "two_inserts"),
    ({"edge_headroom": 2}, "wide_insert")])
def test_capacity_errors_where_repro_raises(sweep, kw, ops):
    """Core slots exhausted with ``core_headroom=1``; core edges over
    ``edge_cap``. Both packages raise on the same op and keep their
    current version."""
    core = [int(c) for c in sweep["j_idx"].core_ids[:3]]
    batch = ([("insert", N_BASE, (core[0],), (2.0,)),
              ("insert", N_BASE + 1, (core[1],), (3.0,))]
             if ops == "two_inserts" else
             [("insert", N_BASE, tuple(core[:2]), (2.0, 3.0))])
    j_mgr = JManager.from_index(sweep["j_idx"], **kw)
    mgr = VersionManager.from_index(sweep["idx"], **kw)
    assert mgr.family.core_cap == j_mgr.family.core_cap
    assert mgr.family.edge_cap == j_mgr.family.edge_cap
    ok = batch[:-1]
    if ok:
        j_mgr.apply([JOp(*op) for op in ok])
        mgr.apply(_ops(ok))
    with pytest.raises(JFamilyCapacityError):
        j_mgr.apply([JOp(*op) for op in batch[-1:]])
    with pytest.raises(FamilyCapacityError):
        mgr.apply(_ops(batch[-1:]))
    assert mgr.current.vid == j_mgr.current.vid == len(ok)


def test_compressed_row_overflow_is_capacity_error(sweep):
    """A compressed family pins its int32 distance plane: a pushed
    non-integral distance no longer fits, in both packages."""
    nb, src, dst, w = gen.er_graph(N_BASE, 2.4, seed=5)
    cfg = dict(CFG, label_dtype="compressed")
    j_idx = JIndex.build(N, src, dst, w, JConfig(**cfg))
    idx = ISLabelIndex.build(N, src, dst, w, IndexConfig(**cfg),
                             device="cpu", perms=jax_perms(0, N))
    j_mgr = JManager.from_index(j_idx, strict=False)
    mgr = VersionManager.from_index(idx, strict=False)
    assert mgr.family.d_dtype == j_mgr.family.d_dtype == "int32"
    leaf = int(np.flatnonzero(np.asarray(j_idx.level[:N_BASE]) < j_idx.k)[0])
    op = ("insert", N_BASE, (leaf,), (1.5,))
    with pytest.raises(JFamilyCapacityError, match="delta16"):
        j_mgr.apply([JOp(*op)])
    with pytest.raises(FamilyCapacityError, match="delta16"):
        mgr.apply([MutationOp(*op)])
    assert mgr.current.vid == 0


def test_delete_then_reinsert_restores_bitwise(sweep):
    """Delete a live spare attached only to the initial core, replay its
    insertion: every answer returns to the pre-delete version's, in
    both packages, and the two agree."""
    idx = ISLabelIndex.build(N, *sweep["graph"], IndexConfig(**CFG),
                             device="cpu", perms=jax_perms(0, N))
    mgr = VersionManager.from_index(idx)
    for rec in sweep["records"]:
        mgr.apply(_ops(rec["ops"]))
    rec = sweep["records"][-1]
    ins = {op.u: op for ops in sweep["sched"] for op in ops
           if op.kind == "insert"}
    core = {int(c) for c in sweep["j_idx"].core_ids}
    u = next(u for u in rec["live"]
             if all(int(v) in core for v in ins[u].nbrs))
    before = mgr.current
    v_del = mgr.apply([MutationOp("delete", u)])
    v_re = mgr.apply([MutationOp(*ins[u])])
    fn = mgr.family.full_fn("reference")
    a, _ = fn(before.state, rec["s"], rec["t"])
    b, _ = fn(v_re.state, rec["s"], rec["t"])
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(a.numpy(), rec["ans"])
    gone, _ = fn(v_del.state, np.full(4, u, np.int32), rec["t"][:4])
    assert np.isinf(gone.numpy()).all()
    assert v_del.vid < v_re.vid == mgr.current.vid


def test_compressed_family_bitwise_vs_fp32(sweep):
    """``tests/test_compression.py``'s versioned case in the port: a
    compressed family carries encoded planes through the swaps, answers
    equal to an fp32 family and to a rebuild on both backends, no new
    batch shape, and a delete restores the first answers."""
    n_base, spares = 150, 8
    n = n_base + spares
    nb, src, dst, w = gen.er_graph(n_base, 2.4, seed=5)
    idx = ISLabelIndex.build(n, src, dst, w, IndexConfig(**CFG),
                             device="cpu")
    cidx = ISLabelIndex.build(n, src, dst, w,
                              IndexConfig(**CFG, label_dtype="compressed"),
                              device="cpu")
    mgr, cmgr = VersionManager.from_index(idx), \
        VersionManager.from_index(cidx)
    assert cmgr.family.codec == "delta16"
    assert cmgr.current.state.lbl_ids.dtype == torch.int16
    backends = ("reference", "cuda")
    r = np.random.default_rng(2)
    s = r.integers(0, n_base, 32).astype(np.int32)
    t = r.integers(0, n_base, 32).astype(np.int32)
    first, sizes = {}, {}
    for be in backends:
        ans0, r0 = mgr.family.full_fn(be)(mgr.current.state, s, t)
        cans0, cr0 = cmgr.family.full_fn(be)(cmgr.current.state, s, t)
        np.testing.assert_array_equal(cans0.numpy(), ans0.numpy())
        assert int(cr0) == int(r0)
        first[be], sizes[be] = cans0.numpy(), cmgr.family.cache_sizes(be)

    core_u = int(idx.core_ids[0])
    ops = [MutationOp("insert", n_base, (core_u,), (1.0,))]
    ver, cver = mgr.apply(ops), cmgr.apply(ops)
    qs = np.concatenate([s[:16], np.full(16, n_base)]).astype(np.int32)
    qt = np.concatenate([np.full(16, n_base), t[:16]]).astype(np.int32)
    es = np.concatenate([src, [core_u, n_base]])
    ed = np.concatenate([dst, [n_base, core_u]])
    ew = np.concatenate([w, [1.0, 1.0]]).astype(np.float32)
    scratch = ISLabelIndex.build(n, es, ed, ew, IndexConfig(**CFG),
                                 device="cpu").query_host(qs, qt)
    # the clone's engine serves the family's encoded planes
    assert cver.index.engine.codec == "delta16"
    np.testing.assert_array_equal(cver.index.query_host(qs, qt), scratch)
    cver2 = cmgr.apply([MutationOp("delete", n_base)])
    for be in backends:
        ans1, r1 = mgr.family.full_fn(be)(ver.state, qs, qt)
        cans1, cr1 = cmgr.family.full_fn(be)(cver.state, qs, qt)
        np.testing.assert_array_equal(cans1.numpy(), ans1.numpy())
        np.testing.assert_array_equal(cans1.numpy(), scratch)
        assert int(cr1) == int(r1)
        cans2, _ = cmgr.family.full_fn(be)(cver2.state, s, t)
        np.testing.assert_array_equal(cans2.numpy(), first[be])
        gone, _ = cmgr.family.full_fn(be)(cver2.state, qs, qt)
        assert np.isinf(gone.numpy()[qs == n_base]).all()
        # no new batch shape: every call was a 32-pair batch
        assert cmgr.family.cache_sizes(be) == sizes[be]


def test_refcount_lifecycle(sweep):
    idx = sweep["idx"]
    mgr = VersionManager.from_index(idx)
    core = int(idx.core_ids[0])
    v0 = mgr.acquire()                     # an in-flight reader pins v0
    assert mgr.refcount(v0) == 1
    v1 = mgr.apply([MutationOp("insert", N_BASE, (core,), (1.0,))])
    with pytest.raises(ValueError, match="current"):
        mgr.retire(v1)
    mgr.retire(v0)                         # pinned: kept until release
    assert mgr.live_versions() == [0, 1]
    mgr.release(v0)
    assert mgr.live_versions() == [1]
    v2 = mgr.apply([MutationOp("delete", N_BASE)])
    pinned = mgr.acquire()
    assert pinned is v2
    v3 = mgr.apply([MutationOp("insert", N_BASE, (core,), (2.0,))])
    assert mgr.drain() == [2]              # v1 dropped, v2 still pinned
    assert mgr.live_versions() == [2, 3]
    mgr.release(v2)
    assert mgr.drain() == [] and mgr.live_versions() == [3]
    assert mgr.current is v3
    mgr.release(v2)                        # a late release is harmless


def test_version_family_gauges(sweep):
    """Live count, current vid, and state bytes with a storage shared
    between versions counted once: an empty batch touches no row, so
    its version shares the parent's label planes."""
    mgr = VersionManager.from_index(sweep["idx"])

    def nbytes(ts):
        return sum(t.untyped_storage().nbytes() for t in ts)

    st0 = mgr.current.state
    planes = nbytes([st0.lbl_ids, st0.lbl_d])
    alone = version_family_gauges(mgr, MetricRegistry(), server="g")
    assert alone["live"] == 1 and alone["current_vid"] == 0
    v1 = mgr.apply([])
    assert v1.state.lbl_ids is st0.lbl_ids
    reg = MetricRegistry()
    both = version_family_gauges(mgr, reg, server="g")
    assert both == {"live": 2, "current_vid": 1,
                    "state_bytes": 2 * alone["state_bytes"] - planes}
    assert reg.gauge("versions.live").value(server="g") == 2
    assert reg.gauge("versions.state_bytes").value(server="g") == \
        both["state_bytes"]
    assert reg.gauge("versions.current_vid").value(server="g") == 1
