"""Host-side data pipelines — the port of ``repro.data.pipeline``.

Two halves:

* ``PrefetchPipeline`` — double-buffered host->device prefetch for the
  training loop: a worker thread builds each batch, pins it, and copies
  it to the card on a side CUDA stream, so generation and the copy
  overlap the step; seekable via ``reset(step)`` for fault-tolerant
  replay.
* graph sources for index construction at 10^6–10^7 vertices: a
  chunked SNAP-format edge-list loader for real graphs
  (``load_snap_edgelist``/``save_snap_edgelist``) and
  ``graph_from_spec``, the one-string front door that names any
  generator or on-disk dataset (copies of ``repro``'s numpy code, over
  the port's generators).
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.core.sync import upload
from repro_torch.kernels.backend import resolve_device
from repro_torch.tree import leaves, tree_map


class PrefetchPipeline:
    """``pipe(step)`` returns ``make_batch(step)`` (a tree of numpy
    arrays or host tensors) on ``device`` (the card unless the caller
    names the CPU; ``device_put=False`` keeps the host batch), laid out
    on a mesh by ``shardings`` (a tree of ``distributed.sharding.
    NamedSharding``) when given. Up to ``depth`` batches are built
    ahead. On the card each batch is copied from pinned memory on the
    pipeline's own stream; the worker records an event after the
    copies, and ``__call__`` makes the caller's current stream wait on
    it and marks each tensor used there (``record_stream``), so the
    caching allocator does not reuse its memory while the step reads
    it. A ``make_batch`` error is raised by the ``__call__`` that would
    have returned that batch."""

    def __init__(self, make_batch: Callable[[int], object], depth: int = 2,
                 device_put: bool = True, shardings=None, device=None):
        self.make_batch = make_batch
        self.depth = depth
        self.device_put = device_put
        self.shardings = shardings
        self.device = resolve_device(device) if device_put else None
        self._stream = (torch.cuda.Stream(self.device)
                        if device_put and self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._next_step = 0

    def _put(self, batch):
        """(the batch on the device, the event its copies recorded)."""
        if not self.device_put:
            return batch, None
        host = tree_map(lambda a: upload(a, "cpu") if not isinstance(
            a, torch.Tensor) else a, batch)
        event = None
        if self._stream is not None:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                dev = tree_map(lambda t: t.pin_memory().to(
                    self.device, non_blocking=True), host)
                event = torch.cuda.Event()
                event.record(self._stream)
        else:
            dev = tree_map(lambda t: t.to(self.device, copy=True), host)
        if self.shardings is not None:
            from repro_torch.distributed.sharding import place_tree
            if self._stream is not None:
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self._stream):
                    dev = place_tree(dev, self.shardings)
                    event.record(self._stream)
            else:
                dev = place_tree(dev, self.shardings)
        return dev, event

    def _worker(self, start: int):
        step = start
        while not self._stop.is_set():
            try:
                b = self._put(self.make_batch(step))
            except Exception as e:
                self._q.put(("error", e))
                return
            self._q.put(("ok", (step, b)))
            step += 1

    def reset(self, step: int = 0):
        self.stop()
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self.depth)
        self._next_step = step
        self._thread = threading.Thread(target=self._worker, args=(step,),
                                        daemon=True)
        self._thread.start()

    def __call__(self, step: int):
        """Fetch the batch for ``step`` (seek-aware)."""
        if self._thread is None or step != self._next_step:
            self.reset(step)
        kind, payload = self._q.get()
        if kind == "error":
            raise payload
        got_step, (batch, event) = payload
        assert got_step == step, (got_step, step)
        self._next_step = step + 1
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in leaves(batch):
                local = getattr(t, "_local_tensor", t)
                local.record_stream(cur)
        return batch

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# Graph sources for million-vertex index construction (docs/CONSTRUCTION.md)


def load_snap_edgelist(path, max_w: int = 1, seed: int = 0,
                       chunk_lines: int = 2_000_000, relabel: bool = True):
    """Load a SNAP-format edge list: ``# comment`` header lines, then one
    ``u v`` (or ``u v w``) pair per line, whitespace-separated.

    The file is parsed in ``chunk_lines``-line blocks (a 10^7-edge file
    never materializes all its token strings at once); each block is
    canonicalized to (lo < hi) and deduped on arrival, mirroring the
    chunked generators. SNAP ids are sparse, so ``relabel`` compacts
    them to [0, n) (order-preserving). Files without a weight column get
    unit weights when ``max_w == 1``, else integer weights in
    [1, max_w] from ``seed`` — same convention as the generators.

    Returns ``(n, src, dst, w)`` with both edge directions.
    """
    from repro_torch.graphs.generators import (_finalize, _pack_pairs,
                                               _unpack_keys)

    raw_max = 0
    cols = None
    key_chunks, weighted_edges = [], []
    with open(path) as fh:
        while True:
            lines = fh.readlines(chunk_lines * 16)   # ~16 bytes/line hint
            if not lines:
                break
            toks = " ".join(ln for ln in lines if not ln.startswith(("#", "%"))).split()
            if not toks:
                continue
            if cols is None:
                # column count from the first data line
                first = next(ln for ln in lines
                             if not ln.startswith(("#", "%")) and ln.strip())
                cols = len(first.split())
                if cols not in (2, 3):
                    raise ValueError(
                        f"SNAP edge list needs 2 or 3 columns, got {cols}")
            arr = np.array(toks, np.float64).reshape(-1, cols)
            uv = arr[:, :2].astype(np.int64)
            raw_max = max(raw_max, int(uv.max()) + 1 if len(uv) else 0)
            if cols == 3:
                weighted_edges.append((uv, arr[:, 2].astype(np.float32)))
            else:
                key_chunks.append(uv)
    if cols == 3:
        uv = np.concatenate([e for e, _ in weighted_edges])
        wt = np.concatenate([w for _, w in weighted_edges])
        u, v = uv[:, 0], uv[:, 1]
        if relabel:
            uniq, inv = np.unique(uv.reshape(-1), return_inverse=True)
            u, v = inv.reshape(-1, 2).T
            raw_max = len(uniq)
        keep = u != v
        lo = np.minimum(u[keep], v[keep]).astype(np.int64)
        hi = np.maximum(u[keep], v[keep]).astype(np.int64)
        # min weight per canonical pair (duplicate rows keep the cheapest)
        order = np.lexsort((wt[keep], lo * np.int64(raw_max) + hi))
        key = (lo * np.int64(raw_max) + hi)[order]
        first = np.concatenate([[True], key[1:] != key[:-1]])
        pairs = np.stack([key[first] // raw_max, key[first] % raw_max], 1)
        n = raw_max
        rng = np.random.default_rng(seed)
        return _finalize(n, pairs, rng, max_w, weights=wt[keep][order][first])
    keys = [_pack_pairs(raw_max, c[:, 0], c[:, 1]) for c in key_chunks]
    keys = np.unique(np.concatenate(keys)) if len(keys) > 1 else keys[0]
    pairs = _unpack_keys(raw_max, keys)
    n = raw_max
    if relabel:
        uniq, inv = np.unique(pairs.reshape(-1), return_inverse=True)
        pairs = inv.reshape(-1, 2)
        n = len(uniq)
    rng = np.random.default_rng(seed)
    weights = (np.ones(len(pairs), np.float32) if max_w <= 1
               else rng.integers(1, max_w + 1, size=len(pairs)).astype(np.float32))
    return _finalize(n, pairs, rng, max_w, weights=weights)


def save_snap_edgelist(path, n, src, dst, w=None, comment: str = ""):
    """Write the canonical (u < v) edges as a SNAP-format text file —
    the round-trip partner of ``load_snap_edgelist`` (u v [w] rows)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    keep = src < dst                       # one row per undirected edge
    rows = np.stack([src[keep], dst[keep]], 1)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        fh.write(f"# {comment or 'repro graph'}\n# Nodes: {n} Edges: {keep.sum()}\n")
        if w is None:
            np.savetxt(fh, rows, fmt="%d")
        else:
            np.savetxt(fh, np.concatenate(
                [rows, np.asarray(w)[keep][:, None]], 1), fmt="%d %d %g")
    return path


def graph_from_spec(spec: str):
    """Build ``(n, src, dst, w)`` from a one-string spec.

    Formats: ``er:<n>[:avg_deg]``, ``rmat:<n_pow>[:avg_deg]``,
    ``pa:<n>[:m_per]``, ``grid:<side>``, ``snap:<path>`` — each with an
    optional trailing ``@seed`` (default 0).
    """
    from repro_torch.graphs import generators as gen

    spec, _, seed_s = spec.partition("@")
    seed = int(seed_s) if seed_s else 0
    kind, *args = spec.split(":")
    if kind == "er":
        n = int(args[0])
        deg = float(args[1]) if len(args) > 1 else 3.0
        return gen.er_graph(n, deg, seed=seed)
    if kind == "rmat":
        p = int(args[0])
        deg = float(args[1]) if len(args) > 1 else 8.0
        return gen.rmat_graph(p, deg, seed=seed)
    if kind == "pa":
        n = int(args[0])
        m_per = int(args[1]) if len(args) > 1 else 2
        return gen.pa_graph(n, m_per, seed=seed)
    if kind == "grid":
        return gen.grid_graph(int(args[0]), seed=seed)
    if kind == "snap":
        return load_snap_edgelist(":".join(args), seed=seed)
    raise ValueError(f"unknown graph spec kind: {kind!r} (in {spec!r})")
