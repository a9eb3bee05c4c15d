"""Batched P2P distance query engine (paper §4.3, §5.2, Algorithm 1),
the counterpart of ``repro.core.query``.

Two stages, exactly the paper's:
  1. label intersection -> upper bound μ (Equation 1); exact and final
     for queries whose shortest path never enters the core G_k.
  2. label-seeded core search as batched bidirectional Bellman-Ford:
     both frontiers' distance vectors over the core are relaxed in
     synchronous rounds to their fixed point; answer =
     min(μ, min_v DS[v] + DT[v]).

Both stages run through ``repro_torch.core.dispatch``. ``query_chunk``
tiles large batches so the per-direction frontier is
``[chunk, n_core+1]``, never ``[Q, n_core+1]``.

A query issues no host sync outside ``host_read``: the relaxation loop
reads its exit flag once every few rounds, and ``query`` reads the round
count once per call.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.dispatch import (CoreRelaxer,
                                       label_intersect_planes_dispatch)
from repro_torch.core.labels import (LabelRows, decode_rows, encode_labels,
                                     row_index, try_encode_labels)
from repro_torch.core.sync import host_arrays, host_read, upload
from repro_torch.kernels.backend import resolve_backend
from repro_torch.obs.trace import count, span

__all__ = ["QueryEngine", "label_intersect_mu", "label_seeds",
           "shape_counted"]

INF = float("inf")


def shape_counted(fn):
    """``fn(..., s, t)`` that records in ``.shapes`` the distinct (s, t)
    batch shapes it has run: the counterpart of the entries of a jit
    cache, which the serving layer's zero-new-shapes check reads. The
    arguments before s and t (a version family's state) are passed
    through."""
    def run(*args):
        s, t = args[-2:]
        run.shapes.add((tuple(np.shape(s)), tuple(np.shape(t))))
        return fn(*args)
    run.shapes = set()
    return run


def label_intersect_mu(ids_s, d_s, ids_t, d_t, n: int, l_cap: int = 0):
    """Equation 1 over sorted label rows: μ[q] = min_{w∈X} d(s,w)+d(w,t).

    Also returns the meeting ancestor (global id; n if none); ``argmin``
    takes the first minimum, as ``jnp.argmin`` does. ``l_cap`` is
    unused (``repro``'s signature, where it was a jit static).
    """
    del l_cap
    pos = torch.searchsorted(ids_t, ids_s)
    pos_c = pos.clamp(max=ids_t.shape[1] - 1)
    hit = (ids_t.gather(1, pos_c) == ids_s) & (ids_s < n)
    tot = torch.where(hit, d_s + d_t.gather(1, pos_c), INF)
    j = tot.argmin(1, keepdim=True)
    mu = tot.gather(1, j)[:, 0]
    meet = torch.where(torch.isfinite(mu), ids_s.gather(1, j)[:, 0], n)
    return mu, meet


def label_seeds(core_pos, n: int, ids, d):
    """Stage-2 label seeds of a [Q, L] label batch: the core position
    (``core_pos``, int32[n+1] on the batch's device) of each entry's
    ancestor (non-core ancestors and padding park in the sentinel column
    n_core) and its distance (+inf for padding), as ``CoreRelaxer.run``
    takes them."""
    cpos = core_pos[torch.clamp(ids, max=n).long()].long()
    return cpos, torch.where(ids < n, d, INF)


class QueryEngine:
    """Holds the device-resident index state and the query entry points.

    ``backend`` selects the kernel path ("auto": the CUDA kernels when
    the labels lie on a CUDA device, the reference elsewhere; see
    ``repro_torch.kernels.backend``). ``query_chunk`` > 0 tiles query
    batches. ``core_local_edges`` are host (numpy) arrays.

    ``label_dtype`` ("fp32" | "compressed" | "auto") selects the label
    storage codec (``core/labels.py``): "compressed" encodes delta16 ids
    (+ int32 distances when integral) and raises
    ``LabelCompressionError`` if the planes don't fit; "auto" compresses
    when it can and keeps fp32 otherwise; ``encoded`` (delta16 planes of
    the same labels, on the engine's device) skips the encode. The
    encoded planes live on the
    engine's device; stage 1 reads them through the packed kernel and
    the stage-2 seeds decode them. Stage 1 reads label rows in place by
    endpoint id in either codec; only the stage-2 seeds gather rows.
    """

    def __init__(self, lbl_ids, lbl_d, core_pos, core_local_edges, n: int,
                 n_core: int, max_rounds: int = 0, backend: str = "auto",
                 query_chunk: int = 0, label_dtype: str = "fp32",
                 encoded=None):
        if label_dtype not in ("fp32", "compressed", "auto"):
            raise ValueError(f"unknown label_dtype {label_dtype!r}")
        self.lbl_ids = lbl_ids
        self.lbl_d = lbl_d
        self.device = lbl_ids.device
        self.core_pos = core_pos              # int32[n+1] -> [0..n_core]
        self.n = n
        self.n_core = n_core
        self.l_cap = lbl_ids.shape[1]
        self.max_rounds = max_rounds if max_rounds > 0 else max(n_core, 1)
        self.backend = backend
        self.query_chunk = query_chunk
        self.label_dtype = label_dtype
        self.codec = "none"
        self.enc_ids, self.enc_base, self.enc_d = lbl_ids, None, lbl_d
        if encoded is not None:
            # planes already encoded from these labels (the versioned
            # store's copy-on-write rows): no second encode
            self.codec = "delta16"
            self.enc_ids, self.enc_base, self.enc_d = encoded
        elif label_dtype != "fp32":
            encode = (encode_labels if label_dtype == "compressed"
                      else try_encode_labels)
            # the planes come to the host once per engine, for the encode
            enc = encode(*host_read((lbl_ids, lbl_d)), n)
            if enc is not None:
                self.codec = "delta16"
                self.enc_ids, self.enc_base, self.enc_d = (
                    upload(x, self.device) for x in enc)
        self.relaxer = CoreRelaxer(*core_local_edges, n_core,
                                   device=self.device) if n_core > 0 else None
        self._last_rounds = 0
        self._batch_fns: dict = {}
        self._mu_batch_fns: dict = {}

    def _index(self, x) -> torch.Tensor:
        """Query endpoints as int32 on the index's device (uploads
        without a blocking copy)."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.int32, non_blocking=True)
        return upload(np.asarray(x, np.int32).reshape(-1), self.device)

    def _backend(self, backend):
        return resolve_backend(self.backend if backend is None else backend,
                               self.device)

    def _mu(self, s, t, backend: str):
        """Stage 1 (Equation 1) of int32 endpoint ids on the index's
        device: the kernel reads the label rows in place."""
        return label_intersect_planes_dispatch(
            LabelRows(self.enc_ids, self.enc_base, self.enc_d), s, t, self.n,
            self.codec, backend)

    def _rows(self, idx) -> LabelRows:
        """Gather label rows for a vertex batch in the active codec (ids
        mapped as ``repro`` maps them, ``row_index``)."""
        idx = row_index(idx, self.lbl_ids.shape[0])
        if self.codec == "none":
            return LabelRows(self.lbl_ids[idx], None, self.lbl_d[idx])
        return LabelRows(self.enc_ids[idx], self.enc_base[idx],
                         self.enc_d[idx])

    def _label_seeds(self, ids, d):
        """Stage-2 label seeds of a [Q, L] label batch (``label_seeds``)."""
        return label_seeds(self.core_pos, self.n, ids, d)

    def _query_block(self, s, t, backend: str):
        """One block through both stages. Returns (ans, rounds) with
        rounds a device scalar (None when there is no core)."""
        with span("query.mu"):
            mu = self._mu(s, t, backend)
        if self.n_core == 0:
            return mu, None
        with span("query.seeds"):
            rows_s, rows_t = self._rows(s), self._rows(t)
            ids_s, d_s = decode_rows(rows_s, self.n, self.codec)
            ids_t, d_t = decode_rows(rows_t, self.n, self.codec)
            seeds_s = self._label_seeds(ids_s, d_s)
            seeds_t = self._label_seeds(ids_t, d_t)
        with span("query.relax"):
            ans, _, _, rounds = self.relaxer.run(seeds_s, seeds_t, mu,
                                                 self.max_rounds, backend)
        return ans, rounds

    def query(self, s, t, backend: str | None = None,
              query_chunk: int | None = None):
        """Batched distances float32[Q] on the index's device, inside a
        ``query`` span; counts ``relax.rounds`` (the rounds it reads)."""
        with span("query"):
            ans = self._query(s, t, backend, query_chunk)
        count("relax.rounds", self._last_rounds)
        return ans

    def _query(self, s, t, backend, query_chunk):
        s, t = self._index(s), self._index(t)
        backend = self._backend(backend)
        chunk = self.query_chunk if query_chunk is None else query_chunk
        q = s.shape[0]
        if chunk <= 0 or chunk >= q:
            ans, rounds = self._query_block(s, t, backend)
            self._last_rounds = 0 if rounds is None else int(host_read(rounds))
            return ans
        outs, rounds_all = [], []
        for start in range(0, q, chunk):
            size = min(chunk, q - start)
            sb, tb = s[start:start + size], t[start:start + size]
            if size < chunk:          # fixed shapes: pad with the last pair
                sb = torch.cat([sb, sb[-1:].expand(chunk - size)])
                tb = torch.cat([tb, tb[-1:].expand(chunk - size)])
            ans, rounds = self._query_block(sb, tb, backend)
            outs.append(ans[:size])
            if rounds is not None:
                rounds_all.append(rounds)
        self._last_rounds = (int(host_read(torch.stack(rounds_all).amax()))
                             if rounds_all else 0)
        return torch.cat(outs)

    def query_mu_only(self, s, t, backend: str | None = None):
        """Equation-1-only answers (exact for §5.2 Type-1 queries)."""
        return self._mu(self._index(s), self._index(t),
                        self._backend(backend))

    def classify(self, s, t, level, k):
        """Paper Table 5 endpoint classes: 1 = both core, 2 = one core,
        3 = neither. Accepts numpy arrays, scalars and tensors on any
        device for every argument (the CUDA ones come over in one
        ``host_read``); always returns a host int array."""
        s, t, level = host_arrays(s, t, level)
        s = np.atleast_1d(s.astype(np.int64))
        t = np.atleast_1d(t.astype(np.int64))
        in_core = (level[s] == k).astype(np.int32) + \
                  (level[t] == k).astype(np.int32)
        return 3 - in_core

    # ------------------------------------------------------- serving APIs
    def batch_fn(self, backend: str | None = None):
        """Fixed-shape batched query callable for serving:
        ``run(s, t) -> (ans float32[Q], rounds int32 device scalar)``
        with no host read of the answers; memoized per resolved
        backend, so every server over the engine shares it and its
        ``shapes`` (``shape_counted``)."""
        backend = self._backend(backend)
        if backend not in self._batch_fns:
            def run(s, t):
                ans, rounds = self._query_block(self._index(s),
                                                self._index(t), backend)
                if rounds is None:
                    rounds = torch.zeros((), dtype=torch.int32,
                                         device=self.device)
                return ans, rounds
            self._batch_fns[backend] = shape_counted(run)
        return self._batch_fns[backend]

    def mu_batch_fn(self, backend: str | None = None):
        """Fixed-shape Equation-1-only callable ``run(s, t) -> ans``;
        memoized per backend, with its ``shapes``."""
        backend = self._backend(backend)
        if backend not in self._mu_batch_fns:
            def run(s, t):
                return self._mu(self._index(s), self._index(t), backend)
            self._mu_batch_fns[backend] = shape_counted(run)
        return self._mu_batch_fns[backend]

    def warmup(self, batch_sizes, backend: str | None = None,
               mu_only: bool = False) -> dict:
        """Run one dummy batch per (path, size) through ``batch_fn`` /
        ``mu_batch_fn`` (this builds the kernels and the core layouts).
        Returns {(path, size): seconds}."""
        fns = [("mu", self.mu_batch_fn(backend))]
        if not mu_only:
            fns.append(("full", self.batch_fn(backend)))
        out = {}
        for name, fn in fns:
            for size in batch_sizes:
                z = torch.zeros(int(size), dtype=torch.int32,
                                device=self.device)
                t0 = time.perf_counter()
                res = fn(z, z)
                host_read(res[0] if isinstance(res, tuple) else res)
                out[(name, int(size))] = time.perf_counter() - t0
        return out
