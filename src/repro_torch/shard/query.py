"""`ShardedQueryEngine` — Algorithm 1 over P label partitions, the
counterpart of ``repro.shard.query``.

``repro`` runs its shards as a 1-D ``jax.sharding.Mesh`` in one process
(``shard_map`` and one ``lax.pmin``). The port keeps that shape: one
process with an explicit ``torch.device`` per shard
(``sharded_index.shard_devices``). Per batch, for each shard p:

  stage 1  μ_p = Equation 1 over block p (``label_intersect_planes_
           dispatch``). Block p of a contiguous [P, n+1, cap_s] tensor
           is a contiguous [n+1, cap_s] plane, so the label kernel reads
           its rows in place by endpoint id; a delta16 index runs the
           packed kernel on block p's planes. Ancestor-partitioned
           blocks keep every (s, t) match shard-local, so μ = min_p μ_p.
  stage 2  the label-seeded core relaxation from block p's own seeds
           (``label_seeds``) through the ``CoreRelaxer`` of shard p's
           device: the top hierarchy levels are replicated into every
           block (``partition.py``), so each shard seeds the complete
           core frontier and relaxes G_k to the same fixed point. The
           sentinel column may hold different parked non-core entries
           per shard, but no core edge reads or writes it and every
           route's ``through_core`` excludes it (``core/dispatch.py``).
  answer   ans_p = min(μ_p, through_core).

The collective: the P partial answers move to shard 0's device and are
min-reduced once (``_reduce``), the counterpart of ``lax.pmin`` and the
batch's single cross-shard reduction (``collective_count``). Float min
is exact under any grouping, so the answer equals ``QueryEngine``'s
bitwise. ``rounds`` is shard 0's device scalar: every shard runs the
same rounds, and ``last_shard_rounds`` keeps each shard's scalar of the
last batch (no host read) for the tests that assert it.

Per-device state — ``core_pos``, the core COO and one ``CoreRelaxer``
— is built once per distinct device, so P shards on one card share one
relaxer and its layout. Stage 2 still runs once per shard, as in
``repro``: on one card that repeats the same core work P times.

Serving contract as ``QueryEngine``: ``batch_fn``/``mu_batch_fn`` are
memoized per resolved backend with their ``shapes``, no host sync
outside ``host_read`` (the ``ell_loop`` and ``dense`` routes read their
exit flags, per shard), and ``warmup`` runs every batch size.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.dispatch import (CoreRelaxer,
                                       label_intersect_planes_dispatch)
from repro_torch.core.labels import LabelRows, decode_rows, row_index
from repro_torch.core.query import QueryEngine, label_seeds, shape_counted
from repro_torch.core.sync import host_read, upload
from repro_torch.kernels.backend import resolve_backend
from repro_torch.obs.registry import REGISTRY

__all__ = ["ShardedQueryEngine"]


def _on(dev: torch.device):
    """Launches, allocations and the current stream on ``dev``."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class ShardedQueryEngine:
    """Per-shard label blocks, per-device core state, and the entry
    points.

    ``lbl_ids``/``lbl_d`` (and the delta16 planes ``enc`` = (deltas,
    base, distances) when ``codec`` is "delta16"): one [P, n+1, cap_s]
    tensor when every shard lies on one device, else a list of P
    [n+1, cap_s] tensors, block p on ``devices[p]``. ``core_pos`` and
    ``core_local_edges`` are host (numpy) arrays, placed here once per
    distinct device.
    """

    def __init__(self, lbl_ids, lbl_d, core_pos, core_local_edges, n: int,
                 n_core: int, devices, max_rounds: int = 0,
                 backend: str = "auto", enc=None, codec: str = "none"):
        self.devices = [torch.device(d) for d in devices]
        self.num_shards = len(self.devices)
        self.device = self.devices[0]
        self.n = n
        self.n_core = n_core
        self.max_rounds = max_rounds if max_rounds > 0 else max(n_core, 1)
        self.backend = backend
        self.codec = codec
        planes = (lbl_ids, None, lbl_d) if codec == "none" else enc
        self.blocks = [LabelRows(*(None if x is None else x[p]
                                   for x in planes))
                       for p in range(self.num_shards)]
        self.cap = self.blocks[0].ids.shape[-1]
        self.core_pos, self.relaxers = {}, {}
        for dev in dict.fromkeys(self.devices):
            self.core_pos[dev] = upload(core_pos, dev)
            self.relaxers[dev] = (CoreRelaxer(*core_local_edges, n_core,
                                              device=dev)
                                  if n_core > 0 else None)
        # shard 0's relaxer: the path lane shares it
        self.relaxer = self.relaxers[self.device]
        self.reductions = 0              # cross-shard reductions run
        self.last_shard_rounds: list = []
        self._last_rounds = 0
        self._batch_fns: dict = {}
        self._mu_batch_fns: dict = {}

    # endpoint ids as int32 on shard 0's device, as the engine uploads them
    _index = QueryEngine._index

    def _backend(self, backend):
        return resolve_backend(self.backend if backend is None else backend,
                               self.device)

    # ------------------------------------------------------- shard-local
    def _shard(self, p: int, s, t, backend: str, mu_only: bool):
        """Both stages on shard p's block; returns (ans_p, rounds_p)
        with rounds_p a device scalar (None on the μ lane or without a
        core)."""
        dev = self.devices[p]
        blk = self.blocks[p]
        with _on(dev):
            s = s.to(dev, non_blocking=True)
            t = t.to(dev, non_blocking=True)
            mu = label_intersect_planes_dispatch(blk, s, t, self.n,
                                                 self.codec, backend)
            if mu_only or self.n_core == 0:
                return mu, None
            seeds = []
            for idx in (s, t):
                idx = row_index(idx, blk.ids.shape[0])
                rows = LabelRows(blk.ids[idx],
                                 None if blk.base is None else blk.base[idx],
                                 blk.d[idx])
                seeds.append(label_seeds(self.core_pos[dev], self.n,
                                         *decode_rows(rows, self.n,
                                                      self.codec)))
            ans, _, _, rounds = self.relaxers[dev].run(
                *seeds, mu, self.max_rounds, backend)
            return ans, rounds

    def _reduce(self, parts):
        """The batch's one cross-shard reduction: the partial answers
        on shard 0's device, min-reduced (the ``lax.pmin`` of
        ``repro``)."""
        self.reductions += 1
        return torch.stack([x.to(self.device, non_blocking=True)
                            for x in parts]).amin(0)

    def _run(self, s, t, backend: str, mu_only: bool):
        s, t = self._index(s), self._index(t)
        parts = [self._shard(p, s, t, backend, mu_only)
                 for p in range(self.num_shards)]
        ans = self._reduce([a for a, _ in parts])
        if mu_only:
            return ans
        self.last_shard_rounds = [r for _, r in parts]
        rounds = parts[0][1]
        if rounds is None:
            rounds = torch.zeros((), dtype=torch.int32, device=self.device)
        return ans, rounds

    def _counted(self, fn, path: str):
        """``shard.batches{path,shards}``: sharded batch dispatches in
        the process registry."""
        calls = REGISTRY.counter("shard.batches", "sharded batch dispatches")
        labels = {"path": path, "shards": str(self.num_shards)}

        def run(s, t):
            calls.inc(1, **labels)
            return fn(s, t)
        return run

    def prepare(self, backend: str | None = None) -> None:
        """Build every device's route layout now, so its first-use
        build lands in the caller's region (``apply_mutations``)."""
        backend = self._backend(backend)
        for rel in self.relaxers.values():
            if rel is None:
                continue
            if backend == "reference":
                rel.coo()
            else:
                {"dense": rel.dense_adj, "fused": rel.sliced,
                 "ell_loop": rel.csr}[rel.mode]()

    # ------------------------------------------------------- serving APIs
    def batch_fn(self, backend: str | None = None):
        """``run(s, t) -> (ans float32[Q], rounds int32 device scalar)``,
        the sharded twin of ``QueryEngine.batch_fn`` (bitwise-equal
        answers), memoized per resolved backend."""
        backend = self._backend(backend)
        if backend not in self._batch_fns:
            self._batch_fns[backend] = shape_counted(self._counted(
                lambda s, t: self._run(s, t, backend, False), "full"))
        return self._batch_fns[backend]

    def mu_batch_fn(self, backend: str | None = None):
        """Equation-1-only ``run(s, t) -> ans float32[Q]``: per-shard
        partial μ and the one reduction."""
        backend = self._backend(backend)
        if backend not in self._mu_batch_fns:
            self._mu_batch_fns[backend] = shape_counted(self._counted(
                lambda s, t: self._run(s, t, backend, True), "mu"))
        return self._mu_batch_fns[backend]

    def query(self, s, t, backend: str | None = None):
        """Batched distances float32[Q] on shard 0's device (reads the
        round count once)."""
        ans, rounds = self.batch_fn(backend)(s, t)
        self._last_rounds = int(host_read(rounds))
        return ans

    def query_mu_only(self, s, t, backend: str | None = None):
        return self.mu_batch_fn(backend)(s, t)

    # warmup runs the *sharded* entry points per batch size; classify
    # reads no engine state — both are QueryEngine's
    warmup = QueryEngine.warmup
    classify = QueryEngine.classify

    def collective_count(self, batch_size: int = 8,
                         backend: str | None = None) -> int:
        """Cross-shard reductions in one full-path batch of
        ``batch_size`` pairs (asserted to be exactly 1 in tests); sets
        the ``shard.collectives_per_batch`` gauge."""
        z = torch.zeros(int(batch_size), dtype=torch.int32,
                        device=self.device)
        before = self.reductions
        self.batch_fn(backend)(z, z)
        count = self.reductions - before
        REGISTRY.gauge("shard.collectives_per_batch",
                       "cross-shard collectives per full-path batch").set(
            count, shards=str(self.num_shards))
        return count
