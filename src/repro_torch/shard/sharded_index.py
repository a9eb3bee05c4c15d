"""`ShardedIndex` — an IS-LABEL index hosted as P label partitions, the
counterpart of ``repro.shard.sharded_index``.

  sidx = ShardedIndex.from_index(idx, num_shards=4)      # slice + place
  sidx = ShardedIndex.build(n, src, dst, w, cfg, num_shards=4)  # on "cuda"
  ans, rounds = sidx.engine.batch_fn()(s, t)   # bitwise == unsharded
  sidx.save(dir); ShardedIndex.load(dir)
  DistanceServer(sidx)                         # serving, sharded lane

Placement. ``repro`` lays the stacked [P, n+1, cap_s] blocks over a
1-D mesh of P devices and refuses P above the device count
(``make_shard_mesh``). The port places shard p on ``devices[p]``
(``shard_devices``): by default every shard on the index's device, so
one card hosts all P; a list gives each shard its own device. Blocks
that share a device are one contiguous [P, n+1, cap_s] tensor; blocks on
several devices are a list of P [n+1, cap_s] tensors. ``PLACEMENT``
names the leaves that are per shard and those that are replicated once
per device. Queries run through ``ShardedQueryEngine`` (per-shard
stages, one reduction a batch).

``shards.npz`` and ``meta.json`` keep ``repro``'s format, so a
``ShardedIndex`` saved by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.config import BuildStats, IndexConfig
from repro_torch.core.index import (_FROM_REPRO_BACKEND, _TO_REPRO_BACKEND,
                                    _batch)
from repro_torch.core.sync import host_read, upload
from repro_torch.kernels.backend import resolve_device
from repro_torch.obs.profiler import compile_region
from repro_torch.shard.partition import (REPLICATED, LabelBlocks,
                                         assign_shards, partition_labels,
                                         unpartition_labels)
from repro_torch.shard.query import ShardedQueryEngine

# Where each device leaf lives (``repro``'s "graph_index" logical-axis
# rules, distributed/sharding.py:69): label blocks and their delta16
# planes per shard; the core position map and the core COO replicated,
# once per distinct device (``ShardedQueryEngine``), so the core search
# stays shard-local and only the partial answers cross shards.
PLACEMENT = {
    "lbl_ids": "shard", "lbl_d": "shard",
    "lbl_delta": "shard", "lbl_base": "shard", "lbl_denc": "shard",
    "core_pos": "replicated", "core_coo": "replicated",
}


def shard_devices(num_shards: int, devices=None) -> list:
    """One ``torch.device`` per shard.

    ``devices`` None puts every shard on the card (``resolve_device``:
    raises without CUDA); one device (a string or ``torch.device``)
    puts every shard there; a list of ``num_shards`` devices puts shard
    p on ``devices[p]``. Raises ``ValueError`` for a list of another
    length or a device that does not exist (a CUDA index at or above the
    device count). CPU devices with distinct indices ("cpu:0",
    "cpu:1", ...) all name the host, and place the shards one per
    device as distinct cards would.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if devices is None or isinstance(devices, (str, torch.device)):
        devs = [resolve_device(devices)] * num_shards
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != num_shards:
            raise ValueError(f"{len(devs)} device(s) given for "
                             f"{num_shards} shards")
    out = []
    for dev in devs:
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            index = dev.index
            if index is None and count:
                index = torch.cuda.current_device()
            if index is None or index >= count:
                raise ValueError(f"device {dev} does not exist ({count} "
                                 f"CUDA device(s))")
            dev = torch.device("cuda", index)
        elif dev.type != "cpu":
            raise ValueError(f"unsupported shard device {dev}")
        out.append(dev)
    return out


def _place(arr: np.ndarray, devices: list):
    """A per-shard host leaf [P, ...] on the shards' devices: one tensor
    when they share a device, else block p on ``devices[p]``."""
    if len(set(devices)) == 1:
        return upload(arr, devices[0])
    return [upload(arr[p], dev) for p, dev in enumerate(devices)]


@dataclasses.dataclass
class ShardedIndex:
    """Duck-types the ``ISLabelIndex`` surface the serving layer uses
    (n/k/level/stats/engine/device/query), with partitioned label
    state."""
    n: int
    k: int
    num_shards: int
    strategy: str
    replicate_top: int
    cfg: IndexConfig
    level: np.ndarray            # int32[n] (host)
    shard_of: np.ndarray         # int32[n+1], REPLICATED = -1
    entries_per_shard: np.ndarray  # int64[P]: owned + replicated per shard
    # per-shard fp32 label blocks on the shards' devices ([P, n+1, cap_s]
    # or a list of P [n+1, cap_s]); pred stays on the host — queries
    # never read it (paths and save/load do)
    lbl_ids: object
    lbl_d: object
    lbl_pred: np.ndarray
    # core graph (host, global ids) and the host core position map
    core_ids: np.ndarray
    core_pos_host: np.ndarray
    core_src: np.ndarray
    core_dst: np.ndarray
    core_w: np.ndarray
    devices: list
    engine: ShardedQueryEngine
    stats: BuildStats
    # path-reconstruction state (host): None on an index saved without
    # it — path queries and mutations then raise
    core_via: np.ndarray | None = None
    up_ids: np.ndarray | None = None
    up_w: np.ndarray | None = None
    up_via: np.ndarray | None = None
    partition_seconds: float = 0.0   # assign + partition, in from_index
    _paths: object = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        """Shard 0's device: where answers are reduced and returned."""
        return self.devices[0]

    # ---------------------------------------------------------- builders
    @staticmethod
    def build(n, src, dst, w, cfg: IndexConfig = IndexConfig(), *,
              num_shards: int = 1, strategy: str = "level",
              replicate_top: int = 1, device=None, devices=None,
              perms=None) -> "ShardedIndex":
        """Build an ``ISLabelIndex`` on ``device`` (the card when None)
        and partition it over ``devices`` (default: that device)."""
        from repro_torch.core.index import ISLabelIndex
        idx = ISLabelIndex.build(n, src, dst, w, cfg, device=device,
                                 perms=perms)
        return ShardedIndex.from_index(idx, num_shards, strategy=strategy,
                                       replicate_top=replicate_top,
                                       devices=devices)

    @staticmethod
    def from_index(index, num_shards: int, *, strategy: str = "level",
                   replicate_top: int = 1, devices=None) -> "ShardedIndex":
        """Partition an existing ``ISLabelIndex`` and place the blocks
        (every shard on the index's device unless ``devices`` says
        otherwise)."""
        devices = shard_devices(num_shards, index.device if devices is None
                                else devices)
        ids, d, pred = host_read((index.lbl_ids, index.lbl_d,
                                  index.lbl_pred))
        t0 = time.perf_counter()
        shard_of = assign_shards(index.level, index.k, num_shards,
                                 strategy=strategy,
                                 replicate_top=replicate_top)
        blocks = partition_labels(ids, d, pred, index.n, shard_of,
                                  num_shards)
        part_s = time.perf_counter() - t0
        out = ShardedIndex._assemble(
            n=index.n, k=index.k, cfg=index.cfg, level=index.level,
            shard_of=shard_of, blocks=blocks, core_ids=index.core_ids,
            core_pos=index.core_pos_host, core_src=index.core_src,
            core_dst=index.core_dst, core_w=index.core_w,
            stats=index.stats, strategy=strategy,
            replicate_top=replicate_top, devices=devices,
            core_via=index.core_via, up_ids=index.up_ids,
            up_w=index.up_w, up_via=index.up_via)
        out.partition_seconds = part_s
        return out

    @staticmethod
    def _assemble(*, n, k, cfg, level, shard_of, blocks: LabelBlocks,
                  core_ids, core_pos, core_src, core_dst, core_w, stats,
                  strategy, replicate_top, devices, core_via=None,
                  up_ids=None, up_w=None, up_via=None) -> "ShardedIndex":
        host = {"lbl_ids": blocks.ids, "lbl_d": blocks.d}
        # partition_labels keeps each block row as [reals..., pads], the
        # layout the codec needs, so the blocks encode row-locally
        codec = "none"
        if cfg.label_dtype != "fp32":
            from repro_torch.core.labels import (encode_labels,
                                                 try_encode_labels)
            encode = (encode_labels if cfg.label_dtype == "compressed"
                      else try_encode_labels)
            enc = encode(blocks.ids, blocks.d, n)
            if enc is not None:
                codec = "delta16"
                host["lbl_delta"], host["lbl_base"], host["lbl_denc"] = enc
        dev = {name: _place(host[name], devices)
               for name, where in PLACEMENT.items()
               if where == "shard" and name in host}
        core_pos = np.asarray(core_pos, np.int32)
        engine = ShardedQueryEngine(
            dev["lbl_ids"], dev["lbl_d"], core_pos,
            (core_pos[np.asarray(core_src)].astype(np.int32),
             core_pos[np.asarray(core_dst)].astype(np.int32),
             np.asarray(core_w, np.float32)),
            n=n, n_core=len(core_ids), devices=devices,
            max_rounds=cfg.max_relax_rounds, backend=cfg.query_backend,
            codec=codec,
            enc=None if codec == "none" else (dev["lbl_delta"],
                                              dev["lbl_base"],
                                              dev["lbl_denc"]))
        return ShardedIndex(
            n=n, k=k, num_shards=blocks.num_shards, strategy=strategy,
            replicate_top=replicate_top, cfg=cfg, level=np.asarray(level),
            shard_of=shard_of, entries_per_shard=np.asarray(blocks.entries),
            lbl_ids=dev["lbl_ids"], lbl_d=dev["lbl_d"],
            lbl_pred=np.asarray(blocks.pred), core_ids=np.asarray(core_ids),
            core_pos_host=core_pos, core_src=np.asarray(core_src),
            core_dst=np.asarray(core_dst), core_w=np.asarray(core_w),
            devices=list(devices), engine=engine, stats=stats,
            core_via=None if core_via is None else np.asarray(core_via),
            up_ids=None if up_ids is None else np.asarray(up_ids),
            up_w=None if up_w is None else np.asarray(up_w),
            up_via=None if up_via is None else np.asarray(up_via))

    # ------------------------------------------------------------- query
    def query(self, s, t, backend: str | None = None):
        """Exact batched distances (float32[Q] on shard 0's device),
        bitwise equal to the unsharded ``ISLabelIndex.query``."""
        return self.engine.query(s, t, backend)

    def query_host(self, s, t) -> np.ndarray:
        return host_read(self.query(_batch(s), _batch(t)))

    def query_types(self, s, t):
        return self.engine.classify(s, t, self.level, self.k)

    def shard_entry_counts(self) -> np.ndarray:
        """int64[P]: label entries held per shard (owned + replicated),
        recorded at partition time — no device read."""
        return self.entries_per_shard.copy()

    def host_blocks(self):
        """Host copies of the fp32 blocks (ids, d), [P, n+1, cap_s] each,
        in one ``host_read``."""
        if isinstance(self.lbl_ids, torch.Tensor):
            return host_read((self.lbl_ids, self.lbl_d))
        parts = host_read(tuple(self.lbl_ids) + tuple(self.lbl_d))
        p = self.num_shards
        return np.stack(parts[:p]), np.stack(parts[p:])

    # ------------------------------------------------------------- paths
    def gather_label_rows(self):
        """Full [n+1, l_cap] label arrays reassembled on the host from
        the blocks (``unpartition_labels``, the bit-exact inverse of the
        partition)."""
        ids, d = self.host_blocks()
        blocks = LabelBlocks(ids=ids, d=d, pred=self.lbl_pred,
                             entries=self.entries_per_shard)
        return unpartition_labels(blocks, self.n, self.cfg.l_cap)

    def path_engine(self):
        """Batched path reconstruction over the sharded index: the
        label rows are gathered once from the blocks and the port's
        ``PathEngine`` is built over them on shard 0's device (sharing
        its relaxer), so sharded and unsharded path answers agree
        bitwise. The distance lanes keep the labels partitioned."""
        if self._paths is None:
            if self.up_ids is None:
                raise ValueError(
                    "this ShardedIndex was saved without path state "
                    "(up-edge matrices); rebuild with "
                    "ShardedIndex.from_index to serve path queries")
            from repro_torch.paths import PathEngine
            ids, d, pred = self.gather_label_rows()
            dev = self.device
            self._paths = PathEngine(
                n=self.n, k=self.k, lbl_ids=upload(ids, dev),
                lbl_d=upload(d, dev), lbl_pred=upload(pred, dev),
                up_ids=self.up_ids, up_w=self.up_w, up_via=self.up_via,
                core_ids=self.core_ids, core_pos=self.core_pos_host,
                core_src=self.core_src, core_dst=self.core_dst,
                core_w=self.core_w, core_via=self.core_via,
                max_rounds=self.cfg.max_relax_rounds,
                backend=self.cfg.query_backend,
                relaxer=self.engine.relaxer)
        return self._paths

    def shortest_paths(self, s, t, hop_cap: int = 256,
                       backend: str | None = None):
        """Batched shortest paths — same contract as
        ``ISLabelIndex.shortest_paths``."""
        return self.path_engine().paths(s, t, hop_cap=hop_cap,
                                        backend=backend)

    def shortest_path(self, s: int, t: int):
        """Scalar path through the batched engine with escalating
        hop_cap (the serving lane's fallback). A finite distance with an
        empty path means the escalation ceiling was hit."""
        dist, paths, _ = self.shortest_paths([s], [t])
        return float(dist[0]), paths[0]

    # --------------------------------------------------------- mutations
    def apply_mutations(self, ops):
        """§8.3 insert/delete batch over the partitioned label blocks.

        Functional: returns ``(new_index, info)`` and leaves this index
        untouched (callers re-register it). The host mutators
        (``repro_torch.core.index``) run over the gathered label rows;
        then each touched row is rewritten in each block whose kept
        slice changed, so a delete of a shard-owned ancestor touches
        that shard's block, while mutated replicated entries (every
        insert: inserted vertices join the core) rewrite the row in
        every block. Every other block row is kept bitwise.

        The vertex→shard map keeps its assignment; inserted vertices
        become core and REPLICATED. The new ``ShardedQueryEngine``'s
        route layouts are built here, inside
        ``compile_region("mutation")``: a sharded mutation is a
        swap-and-rewarm, not a zero-build one.

        ``info``: {"touched_rows", "touched_shards", "inserted"}.
        """
        from types import SimpleNamespace

        from repro_torch.core.index import (apply_delete_host,
                                            apply_insert_host)
        if self.up_ids is None:
            raise ValueError(
                "this ShardedIndex was saved without the up-edge "
                "matrices; §8.3 mutations need them — rebuild with "
                "ShardedIndex.from_index")
        ids_h, d_h, pred_h = self.gather_label_rows()
        st = SimpleNamespace(
            n=self.n, k=self.k, level=self.level.copy(),
            up_ids=self.up_ids, up_w=self.up_w,
            core_src=self.core_src.copy(), core_dst=self.core_dst.copy(),
            core_w=self.core_w.copy(), core_via=self.core_via.copy(),
            core_ids=self.core_ids.copy())
        shard_of = self.shard_of.copy()
        touched: set = set()
        inserted = []
        for op in ops:
            u = int(op.u)
            if op.kind == "insert":
                apply_insert_host(st, ids_h, d_h, pred_h, u,
                                  [int(v) for v in op.nbrs],
                                  [float(x) for x in op.ws], touched)
                shard_of[u] = REPLICATED        # u joined the core
                inserted.append(u)
            elif op.kind == "delete":
                apply_delete_host(st, ids_h, d_h, pred_h, u, touched)
            else:
                raise ValueError(f"unknown mutation kind {op.kind!r}")
        rows = np.asarray(sorted(touched), np.int64)

        blk_ids, blk_d = self.host_blocks()
        blk_pred = self.lbl_pred.copy()
        entries = self.entries_per_shard.copy()
        cap = blk_ids.shape[2]
        touched_shards: set = set()
        for r in rows:
            valid = ids_h[r] < self.n
            owner = shard_of[np.minimum(ids_h[r], self.n)]
            for p in range(self.num_shards):
                # boolean-mask compaction keeps source order — the
                # layout partition_labels produces
                keep = valid & ((owner == p) | (owner == REPLICATED))
                cnt = int(keep.sum())
                if cnt > cap:
                    raise RuntimeError(
                        f"shard {p} row {r}: {cnt} entries exceed the "
                        f"block cap {cap}; repartition the index")
                new_ids = np.full(cap, self.n, np.int32)
                new_d = np.full(cap, np.inf, np.float32)
                new_pred = np.full(cap, -1, np.int32)
                new_ids[:cnt] = ids_h[r][keep]
                new_d[:cnt] = d_h[r][keep]
                new_pred[:cnt] = pred_h[r][keep]
                if not (np.array_equal(blk_ids[p, r], new_ids)
                        and np.array_equal(blk_d[p, r], new_d)):
                    if r < self.n:
                        entries[p] += cnt - int(
                            (blk_ids[p, r] < self.n).sum())
                    blk_ids[p, r] = new_ids
                    blk_d[p, r] = new_d
                    blk_pred[p, r] = new_pred
                    touched_shards.add(p)
        core_ids = np.flatnonzero(st.level == self.k).astype(np.int32)
        core_pos = np.full(self.n + 1, len(core_ids), np.int32)
        core_pos[core_ids] = np.arange(len(core_ids), dtype=np.int32)
        stats = dataclasses.replace(
            self.stats, n_core=len(core_ids), m_core=len(st.core_src),
            label_entries=int((ids_h[:self.n] < self.n).sum()))
        with compile_region("mutation"):
            new = ShardedIndex._assemble(
                n=self.n, k=self.k, cfg=self.cfg, level=st.level,
                shard_of=shard_of,
                blocks=LabelBlocks(ids=blk_ids, d=blk_d, pred=blk_pred,
                                   entries=entries),
                core_ids=core_ids, core_pos=core_pos, core_src=st.core_src,
                core_dst=st.core_dst, core_w=st.core_w, stats=stats,
                strategy=self.strategy, replicate_top=self.replicate_top,
                devices=self.devices, core_via=st.core_via,
                up_ids=self.up_ids, up_w=self.up_w, up_via=self.up_via)
            new.engine.prepare()
        info = {"touched_rows": rows,
                "touched_shards": sorted(touched_shards),
                "inserted": inserted}
        return new, info

    # ---------------------------------------------------------------- io
    def save(self, path) -> None:
        """Write ``shards.npz`` + ``meta.json`` in ``repro``'s format (the
        query backend in ``repro``'s vocabulary)."""
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        path_state = {}
        if self.up_ids is not None:
            path_state = {"core_via": self.core_via, "up_ids": self.up_ids,
                          "up_w": self.up_w, "up_via": self.up_via}
        ids, d = self.host_blocks()
        np.savez_compressed(
            p / "shards.npz", level=self.level, shard_of=self.shard_of,
            lbl_ids=ids, lbl_d=d, lbl_pred=self.lbl_pred,
            core_ids=self.core_ids, core_pos=self.core_pos_host,
            core_src=self.core_src, core_dst=self.core_dst,
            core_w=self.core_w, **path_state)
        cfg = dataclasses.asdict(self.cfg)
        cfg["query_backend"] = _TO_REPRO_BACKEND.get(cfg["query_backend"],
                                                     cfg["query_backend"])
        meta = {"n": self.n, "k": self.k, "num_shards": self.num_shards,
                "strategy": self.strategy,
                "replicate_top": self.replicate_top, "cfg": cfg,
                "stats": dataclasses.asdict(self.stats)}
        (p / "meta.json").write_text(json.dumps(meta))

    @staticmethod
    def load(path, device=None, devices=None) -> "ShardedIndex":
        """Load a ``ShardedIndex`` saved by either package, every shard
        on ``device`` (the card when None) unless ``devices`` places
        them one by one."""
        p = Path(path)
        meta = json.loads((p / "meta.json").read_text())
        devices = shard_devices(meta["num_shards"],
                                resolve_device(device) if devices is None
                                else devices)
        cfg_d = dict(meta["cfg"])
        cfg_d["query_backend"] = _FROM_REPRO_BACKEND.get(
            cfg_d["query_backend"], cfg_d["query_backend"])
        with np.load(p / "shards.npz") as z:
            a = {name: z[name] for name in z.files}
        n = meta["n"]
        blocks = LabelBlocks(
            ids=a["lbl_ids"], d=a["lbl_d"], pred=a["lbl_pred"],
            entries=(a["lbl_ids"][:, :n] < n).sum(axis=(1, 2))
            .astype(np.int64))
        return ShardedIndex._assemble(
            n=n, k=meta["k"], cfg=IndexConfig(**cfg_d), level=a["level"],
            shard_of=a["shard_of"], blocks=blocks, core_ids=a["core_ids"],
            core_pos=a["core_pos"], core_src=a["core_src"],
            core_dst=a["core_dst"], core_w=a["core_w"],
            stats=BuildStats(**meta["stats"]), strategy=meta["strategy"],
            replicate_top=meta["replicate_top"], devices=devices,
            core_via=a.get("core_via"), up_ids=a.get("up_ids"),
            up_w=a.get("up_w"), up_via=a.get("up_via"))
