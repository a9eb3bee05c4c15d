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
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

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


def _project_qkv(p, cfg: AttnConfig, x, positions, dtype):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(dtype)
    k = x @ p["wk"].to(dtype)
    v = x @ p["wv"].to(dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kv, dh)
    v = v.reshape(b, s, kv, dh)
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
                     dtype=torch.bfloat16):
    """Prefill attention. x: [B, S, E]. Returns ([B, S, E], (k, v)), k and
    v after RoPE: [B, S, KV, Dh]."""
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
                     *, dtype=torch.bfloat16):
    """One-token decode. x: [B, 1, E]; cache_[kv]: [B, Smax, KV, Dh], written
    in place; cache_len: int32[] device tensor, the tokens already in the
    cache. Returns (y, cache_k, cache_v)."""
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
