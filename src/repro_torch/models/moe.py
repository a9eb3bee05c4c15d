"""Mixture-of-Experts FFN: top-k routing with sort-based capacity
dispatch and optional shared experts — the port of ``repro.models.moe``
on one card.

Dispatch is fixed-shape, as in ``repro``: token-expert assignments are
sorted by expert (stable), ranked within their expert (the rank is the
position less the segment minimum), and scattered into an
``[n_total * capacity + 1, E]`` buffer whose last row takes every
assignment past the capacity. The capacity
``int(capacity_factor * k * t / n_experts + 1)`` is computed in Python
from the shapes.

Top-k keeps ``jax.lax.top_k``'s rule that the lower expert wins a tie
(``torch.topk`` does not): the probabilities are sorted descending with
a stable sort and the first k taken, the same on the CPU and the card.

On a mesh (``dist``, ``distributed/sharding.ModelCall``: the step's
batch split over ``dist.dp``) each rank routes its own shard of the
batch as ``repro`` routes the whole batch: the capacity is that of the
global token count, a token's rank in its expert is offset by the
assignments of the shards before it (an all-gather of per-expert counts
in the batch's shard order), and the load-balance loss takes its means
over every token. Under ``compress_pods`` the batch is the pod's
(``dist.dp`` leaves ``pod`` out), as ``repro``'s ``shard_map`` over
``pod`` routes it. The loss's gradient through this rank's router
probabilities is scaled by the shard count, so that the mean over the
ranks the step takes is the whole batch's gradient. The router is read
whole and every rank of a ``model`` group routes the same tokens alike.

The expert products are split over ``model`` as ``lm_rules`` lays the
expert weights out (read from their placement):

* experts over ``model`` (kimi-k2: 384 experts on 16 ranks): a rank
  fills and multiplies only its own experts' rows of the dispatch
  buffer (``[n_total / |model| * capacity + 1, E]``); the tokens are the
  same on every rank of the group, so none moves.
* each expert's ffn over ``model`` (qwen2-moe: 60 % 16 != 0): every
  rank fills the whole buffer and multiplies it by its columns of
  ``w_gate``/``w_up`` and its rows of ``w_down``.

Either way a rank's combine is a partial sum of each token's output;
the shared experts' SwiGLU (its ffn dim over ``model``) adds its own
partial output, and one all-reduce over ``model`` sums them. The
tokens and the gate weights enter through ``ModelCall.to_model`` (their
gradients all-reduced). The buffer holds the global (micro-)batch's
capacity rows on every rank: each rank fills its own tokens' rows, the
rest stay zero (ROADMAP: no all-to-all over the data axes).

``dispatch_shard`` is ``repro``'s layout constraint on the dispatch
buffer, ``(experts, dp, None)``: experts over ``model`` where the
expert count divides it (the weights' layout above), and the capacity
over the batch axes. On a mesh it takes effect: each rank's buffer
(its experts' rows of the global capacity, its own tokens filled) is
padded to a capacity that the batch shards divide, reduce-scattered
over the ``dp`` axes along the capacity (each slot is filled by one
shard, so the sum is that shard's row), multiplied as this rank's block
of the capacity, and all-gathered back for the combine: the expert
products' FLOPs fall by the number of batch shards, the buffer's bytes
do not. ``set_dispatch_mesh`` is ``repro``'s setter for that mesh; the
port's model calls take it as ``dist`` and it does nothing.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed import sharding as SHD
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0
    d_shared_ff: int = 0          # 0 -> n_shared * d_expert_ff
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    dispatch_shard: bool = False  # capacity over the batch axes on a mesh
    ep_pad: int = 0               # pad the expert count (60 -> 64); padded
                                  # experts get no routed tokens
    combine_impl: str = "gather"  # "scatter": segment-sum combine

    @property
    def n_total(self) -> int:
        return max(self.ep_pad, self.n_experts)


def set_dispatch_mesh(mesh):
    """``repro``'s dispatch-buffer mesh setter: the port's model calls
    take their mesh as ``dist`` (the module docstring)."""
    del mesh


class MoE(nn.Module):
    """``repro``'s ``init_moe``: ``router`` [*lead, E, n_experts],
    ``w_gate``/``w_up`` [*lead, n_total, E, F], ``w_down`` [*lead,
    n_total, F, E], and a ``shared`` SwiGLU when ``n_shared``."""

    def __init__(self, d_model: int, cfg: MoEConfig, lead=(), generator=None,
                 dtype=None):
        super().__init__()
        n, f = cfg.n_total, cfg.d_expert_ff
        self.router = L._dense_init((*lead, d_model, cfg.n_experts),
                                    generator, dtype=dtype)
        self.w_gate = L._dense_init((*lead, n, d_model, f), generator,
                                    dtype=dtype)
        self.w_up = L._dense_init((*lead, n, d_model, f), generator,
                                  dtype=dtype)
        self.w_down = L._dense_init((*lead, n, f, d_model), generator,
                                    dtype=dtype)
        if cfg.n_shared:
            dsf = cfg.d_shared_ff or cfg.n_shared * cfg.d_expert_ff
            self.shared = L.SwiGLU(d_model, dsf, lead, generator, dtype)


def moe_axes(cfg: MoEConfig) -> dict:
    """``repro``'s ``init_moe`` axes: experts on their own axis."""
    a = {"router": ("embed", "experts_router"),
         "w_gate": ("experts", "embed", "expert_mlp"),
         "w_up": ("experts", "embed", "expert_mlp"),
         "w_down": ("experts", "expert_mlp", "embed")}
    if cfg.n_shared:
        a["shared"] = L.swiglu_axes()
    return a


class Routing(NamedTuple):
    probs: torch.Tensor       # f32 [T, n_experts]
    gate_v: torch.Tensor      # f32 [T, K], renormalised
    top_i: torch.Tensor       # int64 [T, K], lower expert first on ties
    order: torch.Tensor       # int64 [T*K], stable sort of top_i by expert
    slot: torch.Tensor        # int64 [T*K] buffer row, n_total*cap if dropped
    keep: torch.Tensor        # bool [T*K], rank < cap (in sorted order)
    cap: int


def _shards(dist) -> tuple:
    """(batch shard count, this rank's index): (1, 0) off a mesh."""
    return (1, 0) if dist is None or not dist.dp else dist.shard_index()


def route(p, cfg: MoEConfig, xf, dtype=torch.bfloat16,
          dist=None) -> Routing:
    """Router softmax, top-k and the capacity dispatch of ``xf`` [T, E]
    (on a mesh, this rank's shard of the batch: the module docstring)."""
    t = xf.shape[0]
    logits = (xf @ p["router"].to(dtype)).to(torch.float32)       # [T, N]
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_v, top_i = srt[:, :cfg.top_k], idx[:, :cfg.top_k]         # [T, K]
    gate_v = gate_v / torch.clamp(gate_v.sum(-1, keepdim=True), min=1e-9)

    n, k = cfg.n_total, cfg.top_k
    shards, index = _shards(dist)
    cap = int(cfg.capacity_factor * k * t * shards / cfg.n_experts + 1)
    flat_e = top_i.reshape(-1)                                     # [T*K]
    sorted_e, order = torch.sort(flat_e, stable=True)
    pos = torch.arange(t * k, device=xf.device)
    first = torch.full((n,), t * k, dtype=pos.dtype, device=xf.device)
    first = first.scatter_reduce(0, sorted_e, pos, "amin")        # segment min
    rank = pos - first[sorted_e]
    if shards > 1:        # offset by the earlier shards' assignments
        counts = torch.zeros(n, dtype=pos.dtype, device=xf.device)
        counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
        rank = rank + dist.all_shards(counts)[:index].sum(0)[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank,
                       torch.full_like(rank, n * cap))            # drop row
    return Routing(probs, gate_v, top_i, order, slot, keep, cap)


def moe_ffn(p, cfg: MoEConfig, x, *, dtype=torch.bfloat16, dist=None):
    """x: [B, S, E] -> ([B, S, E], aux_loss); ``dist`` the mesh call
    (the module docstring), None off a mesh."""
    if SHD.tp(dist):
        return _tp_moe(p, cfg, x, dtype, dist)
    b, s, e = x.shape
    t = b * s
    xf = x.reshape(t, e)
    r = route(p, cfg, xf, dtype)
    y = _experts(p, cfg, xf, r, r.gate_v, r.slot, cfg.n_total, dtype)
    if cfg.n_shared:
        y = y + L.swiglu(p["shared"], xf.to(dtype), dtype)
    return y.reshape(b, s, e), _aux(cfg, r, t, None)


def _experts(p, cfg: MoEConfig, xf, r: Routing, gate_v, slot, n: int,
             dtype, dist=None):
    """The routed experts' output [T, E]: ``xf``'s assignments scattered
    to their buffer rows ``slot`` (``n`` experts of ``r.cap`` rows, the
    last row the drop row), the products with ``p``'s ``n`` experts, and
    the combine weighted by ``gate_v``. With ``dist`` the products run
    on this rank's block of the capacity (``dispatch_shard``: the module
    docstring)."""
    t, e = xf.shape
    k, cap = cfg.top_k, r.cap
    token_of = r.order // k

    buf = xf.new_zeros((n * cap + 1, e), dtype=dtype)
    buf[slot] = xf[token_of].to(dtype)
    xe = buf[:-1].view(n, cap, e)
    if dist is not None:
        shards, _ = _shards(dist)
        pad = -cap % shards
        if pad:
            xe = torch.cat([xe, xe.new_zeros((n, pad, e))], 1)
        xe = dist.scatter_dp(xe, 1)

    g = torch.bmm(xe, p["w_gate"].to(dtype))
    u = torch.bmm(xe, p["w_up"].to(dtype))
    # cast before the activations: with bf16 weights and an fp32 dtype the
    # cast then reuses the block w_up's cast freed (21 GB on kimi-k2)
    w_down = p["w_down"].to(dtype)
    he = torch.bmm(F.silu(g) * u, w_down)
    if dist is not None:
        he = dist.gather_dp(he, 1)[:, :cap]
    he_flat = torch.cat([he.reshape(n * cap, e), he.new_zeros((1, e))], 0)

    if cfg.combine_impl == "scatter":
        # each buffer row scatters back to its token with its gate weight
        gate_sorted = gate_v.reshape(-1)[r.order]                  # [T*K]
        tok_slot = torch.full((n * cap + 1,), t, dtype=torch.int64,
                              device=xf.device)
        tok_slot[slot] = token_of
        gate_slot = xf.new_zeros((n * cap + 1,), dtype=torch.float32)
        gate_slot[slot] = gate_sorted
        weighted = he_flat * gate_slot[:, None].to(dtype)
        return he_flat.new_zeros((t + 1, e)).index_add_(
            0, tok_slot, weighted)[:t]
    # gather back: assignment (t, k)'s contribution lives at its slot
    slot_by_assign = torch.empty_like(slot)
    slot_by_assign[r.order] = slot
    contrib = he_flat[slot_by_assign].view(t, k, e)
    return torch.sum(contrib * gate_v[..., None].to(dtype), dim=1)


def _aux(cfg: MoEConfig, r: Routing, t: int, dist):
    """Switch-style load-balance auxiliary loss (over the real experts)."""
    hot = F.one_hot(r.top_i[:, 0], cfg.n_experts).to(torch.float32)
    scale = cfg.router_aux_weight * cfg.n_experts
    shards, _ = _shards(dist)
    if shards == 1:
        me = torch.mean(r.probs, dim=0)                            # [N]
        ce = torch.mean(hot, dim=0)
        return scale * torch.sum(me * ce)
    # means over every shard's tokens; the gradient through this shard's
    # probabilities times the shard count (the module docstring), the
    # value the whole batch's
    t_all = t * shards
    ce = dist.all_shards(hot.sum(0)).sum(0) / t_all
    me = dist.all_shards(r.probs.sum(0)).sum(0) / t_all
    own = shards * scale * torch.sum(r.probs.sum(0) / t_all * ce)
    return scale * torch.sum(me * ce) + (own - own.detach())


def _tp_moe(p, cfg: MoEConfig, x, dtype, dist):
    """``moe_ffn`` on a mesh: the experts or their ffns split over
    ``model`` (the module docstring)."""
    b, s, e = x.shape
    t = b * s
    xf = x.reshape(t, e)
    r = route({"router": dist.whole(p["router"])}, cfg, xf, dtype, dist)
    xin, gate = dist.to_model(xf), dist.to_model(r.gate_v)
    w = {k: dist.shard(p[k]) for k in ("w_gate", "w_up", "w_down")}
    split = dist.model_dim(p["w_gate"])
    if split == 0:                 # experts over model: this rank's block
        n = w["w_gate"].shape[0]
        first = dist.model_range(cfg.n_total)[0]
        local = r.slot - first * r.cap
        slot = torch.where((local >= 0) & (local < n * r.cap), local,
                           torch.full_like(local, n * r.cap))
    elif split == 2:               # each expert's ffn over model
        n, slot = cfg.n_total, r.slot
    else:
        raise ValueError("the expert weights are not split over model")
    y = _experts(w, cfg, xin, r, gate, slot, n, dtype,
                 dist if cfg.dispatch_shard and dist.dp else None)
    if cfg.n_shared:
        y = y + L.swiglu({k: dist.shard(v) for k, v in p["shared"].items()},
                         xin.to(dtype), dtype)
    return dist.from_model(y).reshape(b, s, e), _aux(cfg, r, t, dist)
