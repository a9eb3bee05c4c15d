"""Versioned copy-on-write label blocks for live mutation under traffic,
the counterpart of ``repro.serve.versions``.

A server's entry points must not change when the index mutates: the
first call of an entry point builds its work (the kernel library, the
route's layout) and the serving path counts every batch shape it runs.
This module makes the mutable state an *argument* of the entry points
instead of something they close over.

``VersionFamily`` fixes, once, every shape the query computation touches

  * ``core_cap``  — core-vertex slots (initial core + insert headroom),
  * ``edge_cap``  — COO core-edge slots (padded with +inf sentinel
    edges between sentinel slots: min-plus no-ops),
  * ``ell_width``/``vp`` — ``repro``'s pinned ELL width, kept as the
    capacity check and the route rule (below),

and serves ``run(state, s, t)`` entry points over a ``VersionState``.
Every version of the index is a new state with identical shapes and
dtypes, so a hot swap is a pointer change. Unused capacity is inert by
min-plus algebra: empty core slots hold +inf seeds (never the argmin),
sentinel edges add +inf (never relax anything).

Layout. ``repro`` pins ELL planes ``[vp, ell_width]`` in the state,
which its Pallas kernels read. No kernel of the port reads ELL planes:
the ``ell_loop`` route's ``spmv_relax`` walks an in-edge CSR
(``RelaxCSR``) and the ``fused`` route's ``fused_relax`` walks sliced
in-edges (``SlicedEdges``). So each version carries the layout of the
family's route, built once in ``apply`` from the version's real slot
edges (the sentinel edges relax nothing and are left out), and the read
path never builds one; the padded COO stays for the reference backend.
Both layouts hold the same edges over the same ``vp`` vertices as
``repro``'s planes, and every route computes the same synchronous
rounds, whose minima do not depend on edge order: ``(ans, rounds)``
equal ``repro``'s bitwise. The ELL width check of ``repro``'s
``build_ell`` stays, so ``FamilyCapacityError`` is raised where
``repro`` raises it, and the route is ``repro``'s rule: ``fused`` if
``fused_vmem_bytes(vp, ell_width, bq)`` fits ``FUSED_VMEM_BUDGET``,
else ``ell_loop``; a family has no dense route.

§8.3 mutations are applied copy-on-write through the host mutators of
``repro_torch.core.index`` (``apply_insert_host`` /
``apply_delete_host``): ``LabelBlockStore`` keeps the [n+1, l_cap]
label planes as immutable row blocks; a mutation materializes writable
copies, and ``commit`` shares every block the touched rows missed.
The device planes of a new version are the parent's, cloned, with the
touched rows copied in (``index_copy_``): the parent stays valid.

``VersionManager`` strings this together: ``apply(ops)`` produces a new
immutable ``IndexVersion`` (monotonic vid, cloned host oracle for
audits, fresh state, committed store) and atomically republishes
``current``; readers pin versions with ``acquire``/``release`` so a
retired version is only dropped once its last in-flight batch drains.

Exactness domain (as ``repro``): in strict mode the manager admits
*core-attached* inserts (every neighbour at level k — initial core
vertices or live inserted ones) and deletes of previously-inserted
vertices. Within that domain every served distance equals a
from-scratch rebuild bitwise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sync as hsync
from repro_torch.core.dispatch import (FUSED_VMEM_BUDGET, _core_relax_csr,
                                       _core_relax_fused, core_relax,
                                       label_intersect_planes_dispatch,
                                       seed_rows)
from repro_torch.core.index import (ISLabelIndex, apply_delete_host,
                                    apply_insert_host)
from repro_torch.core.labels import (LabelCompressionError, LabelRows,
                                     decode_rows, encode_labels, row_index)
from repro_torch.core.query import QueryEngine, shape_counted
from repro_torch.kernels.backend import resolve_backend, resolve_device
from repro_torch.kernels.spmv_relax.kernel import (RelaxCSR, SlicedEdges,
                                                   fused_vmem_bytes)
from repro_torch.kernels.spmv_relax.ops import (coo_to_csr, coo_to_sliced,
                                                ell_width)
from repro_torch.obs.profiler import compile_region, record_build

__all__ = [
    "MutationOp", "VersionState", "VersionFamily", "FamilyCapacityError",
    "LabelBlockStore", "IndexVersion", "VersionManager",
]

INF = float("inf")


class FamilyCapacityError(RuntimeError):
    """A mutation outgrew the family's fixed shapes — the serving
    process must rebuild a wider family to admit it."""


class MutationOp(NamedTuple):
    """One §8.3 mutation. kind ∈ {"insert", "delete"}; nbrs/ws describe
    the inserted vertex's edges (ignored for deletes)."""
    kind: str
    u: int
    nbrs: tuple = ()
    ws: tuple = ()


class VersionState(NamedTuple):
    """The state a family entry point takes as its first argument.

    All tensors live on the family's device, with family-fixed shapes:
      lbl_ids/lbl_d   [n+1, l_cap]      label planes — in a compressed
                      family the *encoded* planes (int16 deltas, int32
                      or float32 distances, core/labels.py)
      lbl_base        [n+1]             delta16 row bases; None in an
                      uncompressed family
      core_slot       [n+1]             vertex -> core slot (core_cap = none)
      ce_src/ce_dst   [edge_cap]        COO slot edges, sentinel-padded
      ce_w            [edge_cap]        weights, +inf padding
      relax           the route's layout over vp slots: ``SlicedEdges``
                      (fused) or ``RelaxCSR`` (ell_loop), real edges only
    """
    lbl_ids: torch.Tensor
    lbl_d: torch.Tensor
    core_slot: torch.Tensor
    ce_src: torch.Tensor
    ce_dst: torch.Tensor
    ce_w: torch.Tensor
    relax: RelaxCSR | SlicedEdges
    lbl_base: torch.Tensor | None = None


class VersionFamily:
    """Fixed-shape query family shared by all versions.

    ``mu_fn``/``full_fn`` mirror ``QueryEngine.mu_batch_fn``/``batch_fn``
    (the same kernels, the same two stages of Algorithm 1) but take the
    ``VersionState`` as an argument instead of closing over it. One
    entry point per (lane, backend) for the lifetime of the family,
    however many versions flow through. ``device`` None means the card
    (``resolve_device``).
    """

    def __init__(self, n: int, core_cap: int, edge_cap: int,
                 ell_width: int, *, bq: int = 8, bv: int = 128,
                 codec: str = "none", d_dtype: str | None = None,
                 device=None):
        if core_cap < 1:
            raise ValueError("core_cap must be >= 1")
        self.n = n
        self.core_cap = core_cap
        self.edge_cap = edge_cap
        self.ell_width = ell_width
        self.bq = bq
        self.bv = bv
        self.vp = -(-(core_cap + 1) // bv) * bv
        self.max_rounds = core_cap          # the loops exit at the fixpoint
        # label codec pin: every version of the family encodes the same
        # way, so the state dtypes never move
        self.codec = codec
        self.d_dtype = d_dtype
        self.device = resolve_device(device)
        # fused single-launch relaxation unless repro's working-set model
        # of the pinned ELL width exceeds the budget (then per-round
        # launches)
        self.relax_mode = ("fused" if fused_vmem_bytes(
            self.vp, ell_width, bq) <= FUSED_VMEM_BUDGET else "ell_loop")
        self._mu_fns: dict = {}
        self._full_fns: dict = {}

    def _backend(self, backend):
        return resolve_backend(backend, self.device)

    # endpoint ids as int32 on the family's device, as the engine
    # uploads them
    _index = QueryEngine._index

    @staticmethod
    def _planes(state: VersionState) -> LabelRows:
        return LabelRows(state.lbl_ids, state.lbl_base, state.lbl_d)

    def _seeds(self, state: VersionState, idx):
        """Stage-2 label seeds of a vertex batch: the core slot of each
        label entry's ancestor (non-core ancestors and padding park in
        slot core_cap) and its distance (+inf for padding)."""
        rows = self._planes(state)
        idx = row_index(idx, state.lbl_ids.shape[0])
        base = None if rows.base is None else rows.base[idx]
        ids, d = decode_rows(LabelRows(rows.ids[idx], base, rows.d[idx]),
                             self.n, self.codec)
        slot = state.core_slot[ids.clamp(max=self.n).long()].long()
        return slot, torch.where(ids < self.n, d, INF)

    # ------------------------------------------------------- entry points
    def mu_fn(self, backend: str | None = None):
        """``run(state, s, t) -> mu float32[Q]`` (Equation 1), with its
        ``shapes``."""
        backend = self._backend(backend)
        if backend not in self._mu_fns:
            def run(state, s, t):
                return label_intersect_planes_dispatch(
                    self._planes(state), self._index(s), self._index(t),
                    self.n, self.codec, backend)
            self._mu_fns[backend] = shape_counted(run)
        return self._mu_fns[backend]

    def full_fn(self, backend: str | None = None):
        """``run(state, s, t) -> (ans float32[Q], rounds int32 device
        scalar)`` — both stages of Algorithm 1 over the family shapes,
        with its ``shapes``."""
        backend = self._backend(backend)
        if backend not in self._full_fns:
            cap, max_rounds, bq = self.core_cap, self.max_rounds, self.bq

            def run(state, s, t):
                s, t = self._index(s), self._index(t)
                mu = label_intersect_planes_dispatch(
                    self._planes(state), s, t, self.n, self.codec, backend)
                seeds_s = self._seeds(state, s)
                seeds_t = self._seeds(state, t)
                if backend == "reference":
                    ans, _, _, rounds = core_relax(
                        seed_rows(seeds_s, cap + 1),
                        seed_rows(seeds_t, cap + 1), state.ce_src,
                        state.ce_dst, state.ce_w, mu, cap, max_rounds)
                elif self.relax_mode == "fused":
                    ans, _, _, rounds = _core_relax_fused(
                        seeds_s, seeds_t, state.relax, mu, cap, max_rounds,
                        bq)
                else:
                    ans, _, _, rounds = _core_relax_csr(
                        seeds_s, seeds_t, state.relax, mu, cap, max_rounds,
                        bq)
                return ans, rounds

            self._full_fns[backend] = shape_counted(run)
        return self._full_fns[backend]

    def cache_sizes(self, backend: str | None = None) -> dict:
        """Batch shapes run per entry point (the zero-new-shapes probe:
        serving must never grow these after warmup)."""
        backend = self._backend(backend)
        return {name: len(fns[backend].shapes) if backend in fns else 0
                for name, fns in (("mu", self._mu_fns),
                                  ("full", self._full_fns))}

    # ---------------------------------------------------------- state build
    def build_layout(self, src_slots, dst_slots, w):
        """The route's layout of the real slot edges, on the family's
        device. ``repro``'s ``build_ell`` check stays: the in-degree's
        ELL width must still fit ``ell_width``, else the family is too
        narrow. Counts one first-use build (``relax_layout:<kind>``) in
        the current region."""
        width = ell_width(self.core_cap + 1, np.asarray(dst_slots, np.int64))
        if width > self.ell_width:
            raise FamilyCapacityError(
                f"core in-degree needs ELL width {width} > family "
                f"{self.ell_width}; rebuild with more ell_headroom")
        if self.relax_mode == "fused":
            record_build("relax_layout:sliced")
            return SlicedEdges(*(
                hsync.upload(x, self.device) for x in coo_to_sliced(
                    self.vp, src_slots, dst_slots, w)))
        record_build("relax_layout:csr")
        indptr, src, ws, order, n_heavy = coo_to_csr(self.vp, src_slots,
                                                     dst_slots, w)
        return RelaxCSR(*(hsync.upload(x, self.device)
                          for x in (indptr, src, ws, order)), n_heavy)

    def pad_coo(self, src_slots, dst_slots, w):
        """COO slot-edges padded to ``edge_cap`` with sentinel->sentinel
        +inf edges (scatter-min no-ops on the parked column)."""
        m = len(src_slots)
        if m > self.edge_cap:
            raise FamilyCapacityError(
                f"{m} core edges exceed family edge_cap {self.edge_cap}; "
                f"rebuild with more edge_headroom")
        ce_src = np.full(self.edge_cap, self.core_cap, np.int32)
        ce_dst = np.full(self.edge_cap, self.core_cap, np.int32)
        ce_w = np.full(self.edge_cap, np.inf, np.float32)
        ce_src[:m] = np.asarray(src_slots, np.int32)
        ce_dst[:m] = np.asarray(dst_slots, np.int32)
        ce_w[:m] = np.asarray(w, np.float32)
        return ce_src, ce_dst, ce_w


class LabelBlockStore:
    """Immutable blocked view of the [n+1, l_cap] label planes.

    ``writable()`` materializes full writable copies for the host
    mutators; ``commit(rows)`` builds the successor store, re-slicing
    only the blocks containing touched rows and *sharing* every other
    block object with this store (copy-on-write at block granularity).
    """

    def __init__(self, blocks: list, n_rows: int, block_rows: int):
        self._blocks = blocks        # [(ids, d, pred)] read-only np arrays
        self.n_rows = n_rows
        self.block_rows = block_rows

    @staticmethod
    def from_arrays(ids, d, pred, block_rows: int = 256) -> "LabelBlockStore":
        ids = np.asarray(ids)
        d = np.asarray(d)
        pred = np.asarray(pred)
        n_rows = ids.shape[0]
        blocks = []
        for lo in range(0, n_rows, block_rows):
            hi = min(lo + block_rows, n_rows)
            blk = (ids[lo:hi].copy(), d[lo:hi].copy(), pred[lo:hi].copy())
            for a in blk:
                a.setflags(write=False)
            blocks.append(blk)
        return LabelBlockStore(blocks, n_rows, block_rows)

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    def arrays(self):
        """Concatenated (ids, d, pred) planes: fresh arrays, so the
        blocks stay as they are whatever the caller writes."""
        ids = np.concatenate([b[0] for b in self._blocks])
        d = np.concatenate([b[1] for b in self._blocks])
        pred = np.concatenate([b[2] for b in self._blocks])
        return ids, d, pred

    def writable(self):
        """Fresh writable full copies for the host mutators (the
        concatenation is the copy; ``repro`` copies it once more)."""
        return self.arrays()

    def commit(self, ids_h, d_h, pred_h, rows) -> "LabelBlockStore":
        """Successor store: dirty blocks re-sliced from the mutated host
        arrays, clean blocks shared by reference."""
        dirty = {int(r) // self.block_rows for r in np.asarray(rows).ravel()}
        blocks = []
        for i, blk in enumerate(self._blocks):
            if i in dirty:
                lo = i * self.block_rows
                hi = min(lo + self.block_rows, self.n_rows)
                nb = (ids_h[lo:hi].copy(), d_h[lo:hi].copy(),
                      pred_h[lo:hi].copy())
                for a in nb:
                    a.setflags(write=False)
                blocks.append(nb)
            else:
                blocks.append(blk)
        return LabelBlockStore(blocks, self.n_rows, self.block_rows)

    def shared_blocks(self, other: "LabelBlockStore") -> int:
        """How many block objects two stores share (COW accounting)."""
        mine = {id(b[0]) for b in self._blocks}
        return sum(1 for b in other._blocks if id(b[0]) in mine)


@dataclasses.dataclass
class IndexVersion:
    """One immutable snapshot: the state the family consumes, the COW
    store it came from, and a cloned ``ISLabelIndex`` whose host oracle
    and engine answer audit queries for exactly this version."""
    vid: int
    index: ISLabelIndex
    state: VersionState
    store: LabelBlockStore
    mu_mask: np.ndarray          # bool[n+1]: μ-exact endpoints
    touched_rows: np.ndarray     # rows rewritten vs the parent version
    swap_seconds: float = 0.0
    # per-stage wall time of the apply that produced this version
    # (cow_apply / device_update / publish) — the mutation-lane trace
    # spans are cut from these
    stage_seconds: dict = dataclasses.field(default_factory=dict)

    @property
    def n_core(self) -> int:
        return len(self.index.core_ids)


def _clone_index(index: ISLabelIndex) -> ISLabelIndex:
    """Snapshot clone sharing immutable arrays. ``level`` is the one
    array the host mutators write in place, so it is copied; the core
    COO arrays are rebound (concatenate/filter), never mutated. The
    replace() resets the lazy caches (init=False fields)."""
    clone = dataclasses.replace(index)
    clone.level = index.level.copy()
    return clone


def _copy_rows(plane, rows_dev, values) -> torch.Tensor:
    """A new plane: ``plane`` with ``rows_dev`` replaced by ``values``
    (host) — the parent's tensor is left as it was."""
    out = plane.clone()
    out.index_copy_(0, rows_dev, hsync.upload(values, plane.device))
    return out


class VersionManager:
    """Monotonic version chain with refcounted drain-before-release.

    Single-writer: ``apply`` runs on the serving thread between
    micro-batches. ``current`` republishes atomically (one reference
    assignment); readers ``acquire()`` the version they execute against
    and ``release()`` it after the batch completes, so ``retire``-ing an
    old version only drops it once no in-flight batch pins it.
    """

    def __init__(self, family: VersionFamily, v0: IndexVersion, *,
                 strict: bool = True):
        self.family = family
        self.strict = strict
        self.current = v0
        self._versions = {v0.vid: v0}
        self._refs = {v0.vid: 0}
        self._retired: set = set()
        self._next_vid = v0.vid + 1
        self._core_slot = None       # int32[n+1], set by from_index
        self._next_slot = 0
        self._inserted_live: set = set()

    # ------------------------------------------------------------- build
    @staticmethod
    def from_index(index: ISLabelIndex, *, core_headroom: int = 64,
                   edge_headroom: int = 512, ell_headroom: int = 32,
                   block_rows: int = 256,
                   strict: bool = True) -> "VersionManager":
        from repro_torch.serve.engine import mu_exact_mask
        n_core0 = len(index.core_ids)
        if n_core0 == 0:
            raise ValueError("versioned serving needs a non-empty core: "
                             "strict-mode inserts attach to core vertices")
        core_cap = n_core0 + core_headroom
        edge_cap = len(index.core_src) + edge_headroom
        slot = np.full(index.n + 1, core_cap, np.int32)
        slot[index.core_ids] = np.arange(n_core0, dtype=np.int32)
        base_w = ell_width(core_cap + 1, slot[index.core_dst])
        width = -(-(base_w + ell_headroom) // 16) * 16
        # the family pins the index's label codec: compressed versions
        # flow through COW swaps with the same state dtypes
        eng = index.engine
        codec = eng.codec
        d_dtype = None
        if codec != "none":
            d_dtype = ("int32" if eng.enc_d.dtype == torch.int32
                       else "float32")
        family = VersionFamily(index.n, core_cap, edge_cap, width,
                               codec=codec, d_dtype=d_dtype,
                               device=index.device)
        store = LabelBlockStore.from_arrays(
            *hsync.host_read((index.lbl_ids, index.lbl_d, index.lbl_pred)),
            block_rows=block_rows)
        mgr = VersionManager(family, IndexVersion(
            vid=0, index=index, state=None, store=store,
            mu_mask=mu_exact_mask(index),
            touched_rows=np.zeros(0, np.int64)), strict=strict)
        mgr._core_slot = slot
        mgr._next_slot = n_core0
        mgr.current.state = mgr._build_state(
            eng.enc_ids, eng.enc_d, index, slot, lbl_base=eng.enc_base)
        return mgr

    def _build_state(self, lbl_ids_dev, lbl_d_dev, index, slot,
                     lbl_base=None) -> VersionState:
        fam = self.family
        src_slots = slot[index.core_src]
        dst_slots = slot[index.core_dst]
        coo = fam.pad_coo(src_slots, dst_slots, index.core_w)
        relax = fam.build_layout(src_slots, dst_slots, index.core_w)
        ce_src, ce_dst, ce_w = (hsync.upload(x, fam.device) for x in coo)
        return VersionState(
            lbl_ids=lbl_ids_dev, lbl_d=lbl_d_dev, lbl_base=lbl_base,
            core_slot=hsync.upload(slot, fam.device), ce_src=ce_src,
            ce_dst=ce_dst, ce_w=ce_w, relax=relax)

    # ------------------------------------------------------------- apply
    def apply(self, ops) -> IndexVersion:
        """Copy-on-write §8.3 batch -> new published version.

        On any failure (capacity, strict-domain violation) the manager
        and the current version are untouched — mutations land in local
        copies and commit only on success.
        """
        from repro_torch.serve.engine import mu_exact_mask
        t0 = time.perf_counter()
        cur = self.current
        fam = self.family
        clone = _clone_index(cur.index)
        ids_h, d_h, pred_h = cur.store.writable()
        slot = self._core_slot.copy()
        next_slot = self._next_slot
        live = set(self._inserted_live)
        touched: set = set()
        for op in ops:
            u = int(op.u)
            if op.kind == "insert":
                if self.strict:
                    bad = [int(v) for v in op.nbrs
                           if clone.level[int(v)] != clone.k]
                    if bad:
                        raise ValueError(
                            f"strict mode: insert({u}) attaches to "
                            f"non-core vertices {bad}; only core-attached "
                            f"inserts are rebuild-exact")
                apply_insert_host(clone, ids_h, d_h, pred_h, u,
                                  [int(v) for v in op.nbrs],
                                  [float(x) for x in op.ws], touched)
                if slot[u] == fam.core_cap:
                    if next_slot >= fam.core_cap:
                        raise FamilyCapacityError(
                            "core slots exhausted; rebuild with more "
                            "core_headroom")
                    slot[u] = next_slot
                    next_slot += 1
                live.add(u)
            elif op.kind == "delete":
                if self.strict and u not in live:
                    raise ValueError(
                        f"strict mode: delete({u}) targets a build-time "
                        f"vertex; only previously-inserted vertices delete "
                        f"rebuild-exactly")
                apply_delete_host(clone, ids_h, d_h, pred_h, u, touched)
                live.discard(u)
            else:
                raise ValueError(f"unknown mutation kind {op.kind!r}")
        t_host = time.perf_counter()
        rows = np.asarray(sorted(touched), np.int64)
        lbl_ids_dev, lbl_d_dev, lbl_pred_dev = self._scatter_rows(
            cur, ids_h, d_h, pred_h, rows)
        if fam.codec == "none":
            clone._install_labels(lbl_ids_dev, lbl_d_dev, lbl_pred_dev,
                                  host=(ids_h, d_h, pred_h))
            state = self._build_state(lbl_ids_dev, lbl_d_dev, clone, slot)
        else:
            enc_ids, enc_base, enc_d = self._scatter_state_rows(
                cur, ids_h, d_h, rows)
            # the clone's engine serves the family's encoded planes (the
            # same rows a full re-encode would give)
            clone._install_labels(lbl_ids_dev, lbl_d_dev, lbl_pred_dev,
                                  host=(ids_h, d_h, pred_h),
                                  encoded=(enc_ids, enc_base, enc_d))
            state = self._build_state(enc_ids, enc_d, clone, slot,
                                      lbl_base=enc_base)
        version = IndexVersion(
            vid=self._next_vid, index=clone, state=state,
            store=cur.store.commit(ids_h, d_h, pred_h, rows),
            mu_mask=mu_exact_mask(clone), touched_rows=rows)
        t_dev = time.perf_counter()
        # success: commit manager state, then publish atomically
        self._core_slot, self._next_slot = slot, next_slot
        self._inserted_live = live
        self._next_vid += 1
        self._versions[version.vid] = version
        self._refs[version.vid] = 0
        self.current = version
        t_pub = time.perf_counter()
        version.swap_seconds = t_pub - t0
        version.stage_seconds = {"cow_apply": t_host - t0,
                                 "device_update": t_dev - t_host,
                                 "publish": t_pub - t_dev}
        return version

    def _scatter_rows(self, cur, ids_h, d_h, pred_h, rows):
        """Incremental device update: the parent version's planes,
        cloned, with only the touched rows copied in — the parent stays
        valid (``.at[].set`` without donation, in ``repro``). ``repro``
        pads the row count to a power of two to bound its compile
        shapes; the port copies the exact rows, with the same result."""
        idx = cur.index
        if rows.size == 0:
            return idx.lbl_ids, idx.lbl_d, idx.lbl_pred
        rj = hsync.upload(rows, idx.device)
        return (_copy_rows(idx.lbl_ids, rj, ids_h[rows]),
                _copy_rows(idx.lbl_d, rj, d_h[rows]),
                _copy_rows(idx.lbl_pred, rj, pred_h[rows]))

    def _scatter_state_rows(self, cur, ids_h, d_h, rows):
        """Compressed-family twin of ``_scatter_rows``: re-encode the
        touched rows (delta16 is row-local, so per-row re-encode under
        the family's pinned distance dtype is exact) and copy them into
        clones of the parent's encoded planes. A row that no longer fits
        the codec is a capacity failure, as an ELL-width overflow is."""
        st = cur.state
        if rows.size == 0:
            return st.lbl_ids, st.lbl_base, st.lbl_d
        try:
            delta, base, d_enc = encode_labels(
                ids_h[rows], d_h[rows], self.family.n,
                d_dtype=self.family.d_dtype)
        except LabelCompressionError as e:
            raise FamilyCapacityError(
                f"mutated label rows no longer fit the family's delta16 "
                f"codec ({e}); rebuild the family uncompressed") from e
        rj = hsync.upload(rows, self.family.device)
        return (_copy_rows(st.lbl_ids, rj, delta),
                _copy_rows(st.lbl_base, rj, base),
                _copy_rows(st.lbl_d, rj, d_enc))

    # ---------------------------------------------------------- lifecycle
    def acquire(self) -> IndexVersion:
        """Pin and return the current version (refcount++)."""
        v = self.current
        self._refs[v.vid] += 1
        return v

    def release(self, version: IndexVersion):
        """Unpin; a retired version drops once its last reader leaves."""
        vid = version.vid
        if vid not in self._refs:
            return
        self._refs[vid] -= 1
        if self._refs[vid] <= 0 and vid in self._retired:
            self._drop(vid)

    def retire(self, version: IndexVersion):
        """Mark for release; dropped immediately if unpinned, otherwise
        when the last in-flight reader calls ``release``."""
        vid = version.vid
        if vid == self.current.vid:
            raise ValueError("cannot retire the current version")
        self._retired.add(vid)
        if self._refs.get(vid, 0) <= 0:
            self._drop(vid)

    def _drop(self, vid: int):
        self._versions.pop(vid, None)
        self._refs.pop(vid, None)
        self._retired.discard(vid)

    def drain(self) -> list:
        """Retire every non-current version; returns the vids still
        pinned by in-flight readers (empty = fully drained)."""
        for vid in list(self._versions):
            if vid != self.current.vid and vid not in self._retired:
                self.retire(self._versions[vid])
        return [vid for vid in self._versions if vid != self.current.vid]

    def live_versions(self) -> list:
        return sorted(self._versions)

    def refcount(self, version: IndexVersion) -> int:
        return self._refs.get(version.vid, 0)

    # ------------------------------------------------------------- warmup
    def warmup(self, batch_sizes, backend: str | None = None,
               mu_only: bool = False) -> dict:
        """Run the family entry points once per batch size (mirrors
        ``QueryEngine.warmup``) inside ``compile_region("warmup")``;
        later versions reuse what these calls built — that is the point
        of the family. Returns {(entry point, size): seconds}."""
        state = self.current.state
        fns = [("mu", self.family.mu_fn(backend))]
        if not mu_only:
            fns.append(("full", self.family.full_fn(backend)))
        out = {}
        with compile_region("warmup"):
            for name, fn in fns:
                for size in batch_sizes:
                    z = torch.zeros(int(size), dtype=torch.int32,
                                    device=self.family.device)
                    t0 = time.perf_counter()
                    res = fn(state, z, z)
                    hsync.host_read(res[0] if isinstance(res, tuple)
                                    else res)
                    out[(name, int(size))] = time.perf_counter() - t0
        return out
