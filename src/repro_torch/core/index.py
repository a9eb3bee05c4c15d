"""ISLabelIndex — the public API of the port (the counterpart of
``repro.core.index``).

  idx = ISLabelIndex.build(n, src, dst, w, IndexConfig())   # on "cuda"
  d = idx.query(s_batch, t_batch)           # exact distances, batched
  idx.save(dir); ISLabelIndex.load(dir)

The entry points run on the card unless the caller passes
``device="cpu"``; without CUDA they raise. ``save`` writes the same
``index.npz`` + ``meta.json`` as ``repro``, so an index built by either
package loads and answers in the other. The label codec
(``cfg.label_dtype``) travels in ``meta.json`` beside the fp32 planes,
and the engine encodes them again on load, so a compressed index
crosses too. Paths (§8.1) and mutation (§8.3) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import sync as hsync
from repro_torch.core.config import BuildStats, IndexConfig
from repro_torch.core.hierarchy import Hierarchy, build_hierarchy
from repro_torch.core.labeling import build_labels
from repro_torch.core.query import QueryEngine
from repro_torch.kernels.backend import resolve_device

# backend names of ``repro`` that the port does not have, and back
_FROM_REPRO_BACKEND = {"pallas": "auto", "interpret": "auto"}
_TO_REPRO_BACKEND = {"cuda": "auto"}
ARRAYS = ("level", "lbl_ids", "lbl_d", "lbl_pred", "up_ids", "up_w",
          "up_via", "core_src", "core_dst", "core_w", "core_via")


@dataclasses.dataclass
class ISLabelIndex:
    n: int
    k: int
    cfg: IndexConfig
    level: np.ndarray            # int32[n]
    # device label arrays [n+1, l_cap]
    lbl_ids: torch.Tensor
    lbl_d: torch.Tensor
    lbl_pred: torch.Tensor
    # up-edge matrix (host, for paths/updates) [n+1, d_cap]
    up_ids: np.ndarray
    up_w: np.ndarray
    up_via: np.ndarray
    # core graph: global-id COO (host) + the engine's local-index copy
    core_ids: np.ndarray         # int32[n_core]
    core_pos_host: np.ndarray    # int32[n+1]
    core_src: np.ndarray
    core_dst: np.ndarray
    core_w: np.ndarray
    core_via: np.ndarray
    engine: QueryEngine
    stats: BuildStats

    @property
    def device(self) -> torch.device:
        return self.lbl_ids.device

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(n, src, dst, w, cfg: IndexConfig = IndexConfig(), device=None,
              perms=None) -> "ISLabelIndex":
        """Build on ``device`` ("cuda" when None). ``perms`` is the MIS
        permutation source (``core/mis.py``): one permutation of [0, n)
        per level; the default draws ``torch.randperm`` from
        ``cfg.seed``."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        syncs0 = hsync.sync_count()
        hier = build_hierarchy(n, src, dst, w, cfg, dev, perms)
        t1 = time.perf_counter()
        # the labeler ends on a blocking read of its overflow flags, which
        # waits for every chunk: t2 is the labels' completion time
        lbl_ids, lbl_d, lbl_pred = build_labels(hier, cfg, dev)
        t2 = time.perf_counter()
        idx = ISLabelIndex._assemble(n, hier, lbl_ids, lbl_d, lbl_pred, cfg,
                                     m_input=len(src))
        idx.stats.build_seconds = time.perf_counter() - t0
        idx.stats.peel_seconds = t1 - t0
        idx.stats.label_seconds = t2 - t1
        idx.stats.host_syncs = hsync.sync_count() - syncs0
        if dev.type == "cuda":
            idx.stats.peak_device_bytes = torch.cuda.max_memory_allocated(dev)
        return idx

    @staticmethod
    def _assemble(n, hier: Hierarchy, lbl_ids, lbl_d, lbl_pred,
                  cfg: IndexConfig, m_input: int) -> "ISLabelIndex":
        dev = lbl_ids.device
        core_ids = np.flatnonzero(hier.level == hier.k).astype(np.int32)
        n_core = len(core_ids)
        core_pos = np.full(n + 1, n_core, np.int32)
        core_pos[core_ids] = np.arange(n_core, dtype=np.int32)
        engine = QueryEngine(
            lbl_ids, lbl_d, hsync.upload(core_pos, dev),
            (core_pos[hier.core_src], core_pos[hier.core_dst],
             np.asarray(hier.core_w, np.float32)),
            n=n, n_core=n_core, max_rounds=cfg.max_relax_rounds,
            backend=cfg.query_backend, query_chunk=cfg.query_chunk,
            label_dtype=cfg.label_dtype)
        entries = int(hsync.host_read(
            (lbl_ids[:n] < n).sum(dtype=torch.int64)))
        stats = BuildStats(
            n=n, m=m_input, k=hier.k, n_core=n_core,
            m_core=len(hier.core_src), level_sizes=hier.level_sizes,
            graph_sizes=hier.graph_sizes, label_entries=entries,
            label_bytes=entries * 8, mis_rounds=hier.mis_rounds,
            peel_loop_syncs=hier.host_syncs, peel_iters=hier.peel_iters)
        return ISLabelIndex(
            n=n, k=hier.k, cfg=cfg, level=hier.level, lbl_ids=lbl_ids,
            lbl_d=lbl_d, lbl_pred=lbl_pred, up_ids=hier.up_ids, up_w=hier.up_w,
            up_via=hier.up_via, core_ids=core_ids, core_pos_host=core_pos,
            core_src=hier.core_src, core_dst=hier.core_dst, core_w=hier.core_w,
            core_via=hier.core_via, engine=engine, stats=stats)

    # ------------------------------------------------------------------ query
    def query(self, s, t):
        """Exact batched distances (float32[Q] on the index's device)."""
        return self.engine.query(s, t)

    def query_host(self, s, t) -> np.ndarray:
        return hsync.host_read(self.query(np.atleast_1d(s), np.atleast_1d(t)))

    def query_types(self, s, t):
        return self.engine.classify(s, t, self.level, self.k)

    # ------------------------------------------------------------------ io
    def save(self, path):
        """Write ``index.npz`` + ``meta.json`` in ``repro``'s format (the
        query backend in ``repro``'s vocabulary)."""
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        lbl_ids, lbl_d, lbl_pred = hsync.host_read(
            (self.lbl_ids, self.lbl_d, self.lbl_pred))
        np.savez_compressed(
            p / "index.npz", level=self.level, lbl_ids=lbl_ids, lbl_d=lbl_d,
            lbl_pred=lbl_pred, up_ids=self.up_ids, up_w=self.up_w,
            up_via=self.up_via, core_src=self.core_src,
            core_dst=self.core_dst, core_w=self.core_w,
            core_via=self.core_via)
        cfg = dataclasses.asdict(self.cfg)
        cfg["query_backend"] = _TO_REPRO_BACKEND.get(cfg["query_backend"],
                                                     cfg["query_backend"])
        meta = {"n": self.n, "k": self.k, "cfg": cfg,
                "stats": dataclasses.asdict(self.stats)}
        (p / "meta.json").write_text(json.dumps(meta))

    @staticmethod
    def from_arrays(meta: dict, arrays: dict, device=None) -> "ISLabelIndex":
        """The port's index from the ``meta.json`` dict and the numpy
        arrays of ``index.npz`` (as written by either package)."""
        dev = resolve_device(device)
        cfg_d = dict(meta["cfg"])
        cfg_d["query_backend"] = _FROM_REPRO_BACKEND.get(
            cfg_d["query_backend"], cfg_d["query_backend"])
        cfg = IndexConfig(**cfg_d)
        z = arrays
        hier = Hierarchy(
            n=meta["n"], k=meta["k"], level=np.asarray(z["level"]),
            up_ids=np.asarray(z["up_ids"]), up_w=np.asarray(z["up_w"]),
            up_via=np.asarray(z["up_via"]), core_src=np.asarray(z["core_src"]),
            core_dst=np.asarray(z["core_dst"]), core_w=np.asarray(z["core_w"]),
            core_via=np.asarray(z["core_via"]), level_sizes=[],
            graph_sizes=[], mis_rounds=[])
        idx = ISLabelIndex._assemble(
            meta["n"], hier, hsync.upload(z["lbl_ids"], dev),
            hsync.upload(z["lbl_d"], dev), hsync.upload(z["lbl_pred"], dev),
            cfg, m_input=meta["stats"]["m"])
        idx.stats = BuildStats(**meta["stats"])
        return idx

    @staticmethod
    def load(path, device=None) -> "ISLabelIndex":
        p = Path(path)
        meta = json.loads((p / "meta.json").read_text())
        with np.load(p / "index.npz") as z:
            arrays = {name: z[name] for name in ARRAYS}
        return ISLabelIndex.from_arrays(meta, arrays, device)
