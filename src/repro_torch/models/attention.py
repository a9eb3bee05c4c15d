"""GQA attention: chunked-causal prefill and KV-cache decode — the port of
``repro.models.attention`` on one card.

The arithmetic is ``repro``'s: projections and score products in
``dtype``, the scores divided by ``sqrt(Dh)`` rounded to ``dtype``, then
cast to fp32, masked, softmaxed, and cast back to ``dtype`` for the
product with V. Prefill walks query chunks (the largest ``qc <=
q_chunk`` that divides S) as ``repro``'s ``lax.scan`` does, each chunk
against all S keys.

The GQA products run as one batched matmul per sequence, batched over
the KV heads: ``k[b]`` (``[S, KV, Dh]``) viewed as ``[KV, Dh, S]`` is a
strided batch the matmul reads in place, so neither prefill's K/V nor a
decode step's cache slice is ever copied into a permuted layout (an
einsum over ``(b, kv)`` would copy the whole ``[B, Smax, KV, Dh]`` slice
a layer a step).

Decode writes the new K/V into the caller's cache in place, at
``cache_len`` clamped to ``Smax - 1`` (``dynamic_update_slice``'s
rule), with device ops only: it never reads ``cache_len`` to the host.

**On a mesh** (``dist``, a tensor-parallel ``distributed.sharding.
ModelCall``) the heads are split over ``model`` as ``repro``'s rules
split the columns of ``wq`` (``("embed", "heads")``) and the rows of
``wo`` (``("heads", "embed")``): the rules cut the flattened ``H·Dh``
columns into equal blocks, which need not fall on head boundaries
(yi-34b: 56 heads on 16 ranks, 3.5 a block). The head-aligned rule
(``head_plan``): a rank owns the whole query heads whose first column
lies in its block, and the KV heads those read. Where every rank's
owned heads are exactly its block (granite, qwen2-72b, qwen2-moe and
kimi-k2 on 16 ranks), ``wq``, ``bq`` and ``wo`` are read as this rank's
block (``ModelCall.shard``); otherwise they are gathered whole over
``model`` on purpose and sliced (``ModelCall.gathered``). ``wk``, ``wv``
(and ``bk``, ``bv``) follow the same test against the KV heads: with 8
KV heads on 16 ranks a block is half a head, so they are gathered whole
(a quarter of ``wq``'s bytes at granite's shapes) and each rank
projects only the KV heads its query heads read. A rank with no query
head raises. Each rank runs its heads' attention (the GQA products on
its KV heads, indexed per query head where its heads are not whole
groups), multiplies by its rows of ``wo``, and the partial outputs are
summed over ``model`` (one all-reduce an attention); the input enters
through ``ModelCall.to_model`` (its gradient all-reduced). The
arithmetic per head is the one above, fp32 softmax and ``dtype`` casts.

Decode on a mesh reads a cache whose sequence is split over ``model``
(``repro``'s ``(None, dp, "model", None, None)``): each rank projects
its heads' queries, all-gathers every head's query (``B × H × Dh``),
and runs every head over its block of positions; the fp32 max of the
scores, the sum of their exponentials and the weighted V are
all-reduced over ``model``, and the weights are cast to ``dtype``
before the product with V, as above. The new token's K and V (every KV
head, from ``wk`` and ``wv`` gathered whole) are written by the rank
whose block holds position ``cache_len``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.distributed import sharding as SHD
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False


class Attention(nn.Module):
    """``repro``'s ``init_attention``: ``wq`` [*lead, E, H·Dh], ``wk``,
    ``wv`` [*lead, E, KV·Dh], ``wo`` [*lead, H·Dh, E], and ``bq bk bv``
    (zeros) under ``qkv_bias``."""

    def __init__(self, cfg: AttnConfig, lead=(), generator=None, dtype=None):
        super().__init__()
        h, kv, dh, e = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
        self.wq = L._dense_init((*lead, e, h * dh), generator, dtype=dtype)
        self.wk = L._dense_init((*lead, e, kv * dh), generator, dtype=dtype)
        self.wv = L._dense_init((*lead, e, kv * dh), generator, dtype=dtype)
        self.wo = L._dense_init((*lead, h * dh, e), generator, dtype=dtype)
        if cfg.qkv_bias:
            self.bq = L._fill((*lead, h * dh), 0.0, generator, dtype)
            self.bk = L._fill((*lead, kv * dh), 0.0, generator, dtype)
            self.bv = L._fill((*lead, kv * dh), 0.0, generator, dtype)


def attention_axes(cfg: AttnConfig) -> dict:
    """``repro``'s ``init_attention`` axes."""
    a = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
         "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        a.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    return a


def _project(p, w: str, bias: str, x, heads: int, dh: int, dtype):
    """``x @ p[w] (+ p[bias])`` as [B, S, heads, dh]."""
    y = x @ p[w].to(dtype)
    if bias in p:
        y = y + p[bias].to(dtype)
    return y.reshape(*x.shape[:2], heads, dh)


def _project_qkv(p, cfg: AttnConfig, x, positions, dtype, h=None, kv=None):
    """Q, K, V after RoPE: [B, S, h, Dh] and [B, S, kv, Dh] (``h``,
    ``kv``: the heads ``p``'s columns hold, all of them by default)."""
    h = cfg.n_heads if h is None else h
    kv = cfg.n_kv_heads if kv is None else kv
    dh = cfg.head_dim
    q = _project(p, "wq", "bq", x, h, dh, dtype)
    k = _project(p, "wk", "bk", x, kv, dh, dtype)
    v = _project(p, "wv", "bv", x, kv, dh, dtype)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def score_scale(dh: int, dtype) -> float:
    """``jnp.sqrt(dh).astype(dtype)``: sqrt in fp32, rounded to ``dtype``
    (11.3125 in bf16 for Dh = 128, not 11.3137)."""
    return float(torch.tensor(math.sqrt(dh), dtype=torch.float32).to(dtype))


def _per_sequence(fn, b: int):
    """``fn(i)`` for each sequence, stacked on a new axis 0 (no copy when
    there is one sequence)."""
    if b == 1:
        return fn(0)[None]
    return torch.stack([fn(i) for i in range(b)])


def _gqa_scores(q, k):
    """q: [B, qc, H, Dh], k: [B, S, KV, Dh] -> [B, H, qc, S] (H = G*KV)."""
    b, qc, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, qc, kv, g, dh).permute(0, 2, 3, 1, 4).reshape(
        b, kv, g * qc, dh)
    s = _per_sequence(lambda i: torch.bmm(qg[i], k[i].permute(1, 2, 0)), b)
    # out of place: under the "dots" remat policy the product is kept for
    # the backward and may not change
    s = s / s.new_full((), score_scale(dh, q.dtype))
    return s.view(b, h, qc, k.shape[1])


def _gqa_combine(w, v):
    """w: [B, H, qc, S], v: [B, S, KV, Dh] -> [B, qc, H, Dh]."""
    b, h, qc, s = w.shape
    kv, dh = v.shape[2], v.shape[3]
    g = h // kv
    wg = w.reshape(b, kv, g * qc, s)
    o = _per_sequence(lambda i: torch.bmm(wg[i], v[i].permute(1, 0, 2)), b)
    return o.view(b, kv, g, qc, dh).permute(0, 3, 1, 2, 4).reshape(
        b, qc, h, dh)


def _softmax_masked(scores, mask, dtype):
    """fp32 softmax of ``scores`` where ``mask`` holds, -inf elsewhere,
    cast to ``dtype``."""
    scores = scores.to(torch.float32).masked_fill_(~mask, -torch.inf)
    return torch.softmax(scores, dim=-1).to(dtype)


def q_chunk_size(s: int, q_chunk: int) -> int:
    """The largest chunk <= ``q_chunk`` that divides ``s``."""
    qc = min(q_chunk, s)
    while s % qc:
        qc -= 1
    return qc


def causal_attention(p, cfg: AttnConfig, x, *, q_chunk: int = 512,
                     dtype=torch.bfloat16, dist=None):
    """Prefill attention. x: [B, S, E]. Returns ([B, S, E], (k, v)), k and
    v after RoPE: [B, S, KV, Dh] (on a mesh, the KV heads this rank
    reads: ``head_plan``)."""
    if SHD.tp(dist):
        return _tp_causal(p, cfg, x, q_chunk, dtype, dist)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, pos.expand(b, s), dtype)
    qc = q_chunk_size(s, q_chunk)
    outs = []
    for c0 in range(0, s, qc):
        scores = _gqa_scores(q[:, c0:c0 + qc], k)         # [B, H, qc, S]
        mask = pos[c0:c0 + qc, None] >= pos[None, :]
        outs.append(_gqa_combine(_softmax_masked(scores, mask, dtype), v))
    o = torch.cat(outs, 1) if len(outs) > 1 else outs[0]
    y = o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"].to(dtype)
    return y, (k, v)


def decode_attention(p, cfg: AttnConfig, x, cache_k, cache_v, cache_len,
                     *, dtype=torch.bfloat16, dist=None, max_len=None):
    """One-token decode. x: [B, 1, E]; cache_[kv]: [B, Smax, KV, Dh], written
    in place; cache_len: int32[] device tensor, the tokens already in the
    cache. Returns (y, cache_k, cache_v). On a mesh the cache is this
    rank's block of ``max_len`` positions (the module docstring)."""
    if SHD.tp(dist):
        return _tp_decode(p, cfg, x, cache_k, cache_v, cache_len, dtype,
                          dist, max_len)
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, cache_len.expand(b, 1), dtype)
    smax = cache_k.shape[1]
    slot = cache_len.clamp(0, smax - 1).long().view(1)
    cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
    scores = _gqa_scores(q, cache_k.to(dtype))
    mask = torch.arange(smax, device=x.device) <= cache_len
    w = _softmax_masked(scores, mask, dtype)
    o = _gqa_combine(w, cache_v.to(dtype))
    y = o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"].to(dtype)
    return y, cache_k, cache_v


# ------------------------------------------------------ tensor-parallel
@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """This rank's query heads ``[h0, h1)`` and the KV heads ``[kv0,
    kv1)`` they read; whether the ``model`` blocks of ``wq``/``wo`` and
    of ``wk``/``wv`` are exactly those heads on every rank
    (``q_local``, ``kv_local``); every rank's ``(h0, h1)``."""
    h0: int
    h1: int
    kv0: int
    kv1: int
    q_local: bool
    kv_local: bool
    spans: tuple


def head_plan(cfg: AttnConfig, dist) -> HeadPlan:
    """The head-aligned rule (the module docstring), from the shapes."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    m = dist.model_size()
    spans = []
    for r in range(m):
        lo, hi = dist.model_range(h * dh, r)
        spans.append((-(-lo // dh), -(-hi // dh)))
    if any(a >= b for a, b in spans):
        raise ValueError(f"{h} heads of {dh} columns leave a rank of the "
                         f"{m} model ranks no query head")

    def kvs(a, b):
        return a // g, (b - 1) // g + 1
    q_local = all((a * dh, b * dh) == dist.model_range(h * dh, r)
                  for r, (a, b) in enumerate(spans))
    kv_local = all(tuple(x * dh for x in kvs(a, b)) ==
                   dist.model_range(kv * dh, r)
                   for r, (a, b) in enumerate(spans))
    h0, h1 = spans[dist.model_rank()]
    return HeadPlan(h0, h1, *kvs(h0, h1), q_local, kv_local, tuple(spans))


def _tp_params(p, cfg: AttnConfig, plan: HeadPlan, dist) -> dict:
    """This rank's columns of ``wq``/``bq`` and rows of ``wo`` (its
    heads), and columns of ``wk``/``wv``/``bk``/``bv`` (its KV heads):
    the ``model`` block where it is exactly those, else the parameter
    gathered whole and sliced."""
    dh = cfg.head_dim
    out = {}
    for names, local, a, b in ((("wq", "bq", "wo"), plan.q_local, plan.h0,
                                plan.h1),
                               (("wk", "bk", "wv", "bv"), plan.kv_local,
                                plan.kv0, plan.kv1)):
        for n in names:
            if n not in p:
                continue
            if local:
                out[n] = dist.shard(p[n])
            else:
                out[n] = dist.gathered(p[n]).narrow(
                    0 if n == "wo" else -1, a * dh, (b - a) * dh)
    return out


def _per_head(k, v, cfg: AttnConfig, plan: HeadPlan):
    """The rank's K and V as its query heads read them: as they are
    where its heads are whole groups of its KV heads, else indexed per
    query head ([B, S, h1 - h0, Dh])."""
    g = cfg.n_heads // cfg.n_kv_heads
    if plan.h0 % g == 0 and plan.h1 % g == 0:
        return k, v
    idx = torch.tensor([h // g - plan.kv0 for h in range(plan.h0, plan.h1)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _tp_causal(p, cfg: AttnConfig, x, q_chunk: int, dtype, dist):
    """``causal_attention`` on a mesh: this rank's heads, the partial
    outputs summed over ``model`` (the module docstring)."""
    plan = head_plan(cfg, dist)
    w = _tp_params(p, cfg, plan, dist)
    b, s, _ = x.shape
    hr = plan.h1 - plan.h0
    pos = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(w, cfg, dist.to_model(x), pos.expand(b, s), dtype,
                           hr, plan.kv1 - plan.kv0)
    kq, vq = _per_head(k, v, cfg, plan)
    qc = q_chunk_size(s, q_chunk)
    outs = []
    for c0 in range(0, s, qc):
        scores = _gqa_scores(q[:, c0:c0 + qc], kq)
        mask = pos[c0:c0 + qc, None] >= pos[None, :]
        outs.append(_gqa_combine(_softmax_masked(scores, mask, dtype), vq))
    o = torch.cat(outs, 1) if len(outs) > 1 else outs[0]
    y = o.reshape(b, s, hr * cfg.head_dim) @ w["wo"].to(dtype)
    return dist.from_model(y), (k, v)


def _all_kv(p, cfg: AttnConfig, dist, plan: HeadPlan, w=None) -> dict:
    """``wk``, ``wv`` (``bk``, ``bv``) whole: this rank's reads ``w``
    where it reads every KV head, else gathered whole."""
    if w is not None and plan.kv0 == 0 and plan.kv1 == cfg.n_kv_heads:
        return w
    return {n: dist.gathered(p[n]) for n in ("wk", "bk", "wv", "bv")
            if n in p}


def prefill_kv(p, cfg: AttnConfig, x, kv, start: int, stop: int, dtype,
               dist):
    """K and V of every KV head at positions ``[start, stop)`` (a rank's
    block of the cache, after RoPE) on a mesh: the attention's own
    ``kv`` (``causal_attention``'s) sliced where this rank reads every
    KV head, else projected from ``x`` [B, S, E] with ``wk`` and ``wv``
    gathered whole."""
    plan = head_plan(cfg, dist)
    if plan.kv0 == 0 and plan.kv1 == cfg.n_kv_heads:
        return kv[0][:, start:stop], kv[1][:, start:stop]
    w = _all_kv(p, cfg, dist, plan)
    xs = x[:, start:stop]
    pos = torch.arange(start, stop, device=x.device).expand(xs.shape[0], -1)
    k = _project(w, "wk", "bk", xs, cfg.n_kv_heads, cfg.head_dim, dtype)
    v = _project(w, "wv", "bv", xs, cfg.n_kv_heads, cfg.head_dim, dtype)
    return L.apply_rope(k, pos, cfg.rope_theta), v


def _tp_decode(p, cfg: AttnConfig, x, cache_k, cache_v, cache_len, dtype,
               dist, max_len: int):
    """``decode_attention`` on a mesh over a sequence-sharded cache (the
    module docstring). ``cache_[kv]``: this rank's block [B, Smax_r, KV,
    Dh] of ``max_len`` positions."""
    plan = head_plan(cfg, dist)
    w = _tp_params(p, cfg, plan, dist)
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.head_dim
    hr = plan.h1 - plan.h0
    lo, hi = dist.model_range(max_len)
    if any(a >= b_ for a, b_ in (dist.model_range(max_len, r)
                                 for r in range(dist.model_size()))):
        raise ValueError(f"a cache of {max_len} positions leaves a model "
                         "rank none")
    if hi - lo != cache_k.shape[1]:
        raise ValueError(f"a cache block of {cache_k.shape[1]} positions, "
                         f"not {hi - lo}")
    xin = dist.to_model(x)
    pos = cache_len.expand(b, 1)
    q = L.apply_rope(_project(w, "wq", "bq", xin, hr, dh, dtype), pos,
                     cfg.rope_theta)
    wkv = _all_kv(p, cfg, dist, plan, w)
    k = L.apply_rope(_project(wkv, "wk", "bk", xin, cfg.n_kv_heads, dh,
                              dtype), pos, cfg.rope_theta)
    v = _project(wkv, "wv", "bv", xin, cfg.n_kv_heads, dh, dtype)
    # the owner of position cache_len (clamped) writes; the others write
    # back what they hold
    local = cache_len.clamp(0, max_len - 1).long() - lo
    mine = (local >= 0) & (local < hi - lo)
    slot = local.clamp(0, hi - lo - 1).view(1)
    for cache, new in ((cache_k, k), (cache_v, v)):
        cache.index_copy_(1, slot, torch.where(
            mine, new.to(cache.dtype), cache.index_select(1, slot)))
    # every head's query: each rank's heads padded to the widest rank's
    # count, all-gathered over model
    width = max(b_ - a for a, b_ in plan.spans)
    if hr < width:
        q = torch.cat([q, q.new_zeros((b, 1, width - hr, dh))], 2)
    qa = dist.gather_model(q, 2)
    if any(b_ - a < width for a, b_ in plan.spans):
        idx = [r * width + j for r, (a, b_) in enumerate(plan.spans)
               for j in range(b_ - a)]
        qa = qa.index_select(2, torch.tensor(idx, device=qa.device))
    scores = _gqa_scores(qa, cache_k.to(dtype)).to(torch.float32)
    seen = torch.arange(lo, hi, device=x.device) <= cache_len
    scores = scores.masked_fill_(~seen, -torch.inf)
    top = dist.max_over_model(scores.amax(-1, keepdim=True))
    e = torch.exp(scores - top)
    wts = (e / dist.from_model(e.sum(-1, keepdim=True))).to(dtype)
    o = dist.from_model(_gqa_combine(wts, cache_v.to(dtype)))
    o = o[:, :, plan.h0:plan.h1].reshape(b, 1, hr * dh)
    return dist.from_model(o @ w["wo"].to(dtype)), cache_k, cache_v
