"""Decoder-only LM (dense or MoE) — the port of ``repro.models.transformer``
on one card: ``forward``, ``lm_loss`` and the serving path (``prefill``
and KV-cache ``decode_step``).

The parameter tree is ``repro``'s: the layers' parameters are stacked
on a leading axis (``blocks/attn/wq`` is ``[L, E, H·Dh]``), so carrying
weights between the packages is a rename of ``/`` to ``.``
(``state_from_tree``, ``tree_from_state``) and checkpoints keep
``repro``'s format. ``repro``'s ``lax.scan`` over the stack is a Python
loop over the layers, whose parameters come from one ``unbind(0)`` of
every stacked leaf a call (``_layers``): under autograd its backward is
one ``stack`` of the layers' gradients, where indexing layer ``i`` would
build a zero gradient of the whole stack per layer and sum L of them.
Token ids read embedding rows by jnp's gather rule (``token_rows``).

Activation remat follows ``repro``'s ``jax.checkpoint`` of each layer
(``remat``, ``remat_policy``) when autograd records: ``"none"``
(``nothing_saveable``) keeps a layer's inputs and recomputes the rest in
the backward (``torch.utils.checkpoint``); ``"dots"``
(``dots_saveable``) also keeps the outputs of the layer's matrix
products (a selective-checkpoint context); ``"off"`` or ``remat=False``
keeps everything. Prefill and decode run without autograd and take no
wrapper.

Serving writes the cache in place: ``prefill`` allocates it and writes
each layer's K and V straight into it, and ``decode_step`` writes one
slot a layer and bumps ``cache["len"]`` on the device, then returns the
same dict (``repro`` returns a new cache and its bundle donates the old
one). A decode step reads nothing back to the host.

``lm_axes`` is ``repro``'s logical sharding-axes tree
(``distributed/sharding.py`` maps it onto a mesh); ``abstract_params``
is the parameter tree on the ``meta`` device.

On a mesh every entry point takes ``dist`` (``distributed/sharding.
ModelCall``) and its parameters as DTensors laid out by the rules, and
reads each parameter only where it is used, each layer's at the start
of that layer (inside its remat region, so the forward frees them after
the layer and the recompute reads them again): one layer's parameters
are gathered over the FSDP axes at a time; without remat autograd keeps
every layer's for the backward. The compute is split over ``model`` as
``repro``'s rules split the weights (GSPMD's split of ``repro``'s
matmuls):

* attention: each rank its query heads (``models/attention.py``), the
  partial outputs all-reduced over ``model``;
* SwiGLU: ``w_gate``/``w_up`` by columns, ``w_down`` by rows, one
  all-reduce an ffn; an MoE by experts or by each expert's ffn
  (``models/moe.py``);
* embedding: each rank reads the tokens whose rows lie in its block of
  the vocabulary (``[V / |model|, E]``, rows by jnp's gather rule
  through ``token_rows``; 0 elsewhere), summed over ``model``;
* unembedding and loss: each rank's logits are its vocabulary block
  (``[B, S, V / |model|]``; no rank holds [B, S, V]), and
  ``layers.vocab_cross_entropy`` all-reduces the softmax's terms. Under
  ``tie_embeddings`` the embedding's blocks serve both ends.

Norms are read whole and computed alike on every rank of a ``model``
group; the residual stream is the same on all of them. A split input
enters through ``ModelCall.to_model`` (identity, its gradient
all-reduced) and a partial output leaves through ``from_model`` (an
all-reduce), so each gradient comes back whole on the ranks that
compute with it. ``compress_pods``'s call is the same split inside each
pod (its batch axes without ``pod``).

Serving on a mesh writes each rank's block of the cache's positions
(``repro``'s layout ``(None, dp, "model", None, None)``): prefill takes
the K and V of every KV head at the rank's positions
(``attention.prefill_kv``), and decode attends over the rank's block and
combines the ranks' softmax terms (``attention.decode_attention``).

``act_shard`` (``repro``'s sharding constraint on the residual stream,
``P(dp, None, "model")``) takes effect on a mesh: each layer's input is
kept as this rank's ``model`` slice of the embed dim (a local chunk of
a DTensor) and gathered back inside the layer (an all-gather), so
under remat the saved residuals take 1/|model| of the memory and the
recompute gathers them again.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.distributed import sharding as SHD
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention import (AttnConfig, Attention,
                                          causal_attention, decode_attention,
                                          prefill_kv)
from repro_torch.models.moe import MoE, MoEConfig, moe_ffn
from repro_torch.tree import tree_map, unflatten_paths


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    moe: MoEConfig | None = None
    q_chunk: int = 512
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "none"         # none=nothing_saveable | dots | off
    tie_embeddings: bool = False
    ce_impl: str = "gather"            # "iota": repro's vocab-sharding form
    act_shard: bool = False            # residuals sharded over "model"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                          self.hd, self.rope_theta, self.qkv_bias)

    def _attn_params(self) -> int:
        e = self.d_model
        return e * (self.n_heads * self.hd) * 2 + \
            e * (self.n_kv_heads * self.hd) * 2

    def param_count(self) -> int:
        e, f, v, nl = self.d_model, self.d_ff, self.vocab, self.n_layers
        if self.moe:
            m = self.moe
            ff = m.n_experts * 3 * e * m.d_expert_ff + e * m.n_experts
            if m.n_shared:
                ff += 3 * e * (m.d_shared_ff or m.n_shared * m.d_expert_ff)
        else:
            ff = 3 * e * f
        return nl * (self._attn_params() + ff + 2 * e) + v * e * (
            1 if self.tie_embeddings else 2)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        e, nl = self.d_model, self.n_layers
        m = self.moe
        ff = m.top_k * 3 * e * m.d_expert_ff + e * m.n_experts
        if m.n_shared:
            ff += 3 * e * (m.d_shared_ff or m.n_shared * m.d_expert_ff)
        return nl * (self._attn_params() + ff + 2 * e) + self.vocab * e * 2


def tiny_like(cfg: LMConfig) -> LMConfig:
    """Structurally identical config with tiny dims (smoke tests: the
    parameter tree's structure depends only on the flags)."""
    moe = None
    if cfg.moe:
        moe = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_expert_ff=16,
            d_shared_ff=16 if (cfg.moe.n_shared or cfg.moe.d_shared_ff) else 0)
    return dataclasses.replace(
        cfg, n_layers=2, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
        vocab=64, head_dim=8, moe=moe, q_chunk=8)


def compute_dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------- init
class Block(nn.Module):
    """The ``n_layers`` stacked layers (``repro``'s ``init_layer`` under
    ``vmap``): ``attn``, ``ffn`` (SwiGLU or MoE), ``ln1``, ``ln2``."""

    def __init__(self, cfg: LMConfig, generator=None, dtype=None):
        super().__init__()
        lead = (cfg.n_layers,)
        self.attn = Attention(cfg.attn_cfg(), lead, generator, dtype)
        self.ffn = (MoE(cfg.d_model, cfg.moe, lead, generator, dtype)
                    if cfg.moe else
                    L.SwiGLU(cfg.d_model, cfg.d_ff, lead, generator, dtype))
        self.ln1 = L.RMSNorm(cfg.d_model, lead, generator, dtype)
        self.ln2 = L.RMSNorm(cfg.d_model, lead, generator, dtype)


class LM(nn.Module):
    """``repro``'s ``init_lm`` tree as a module: ``embed`` [V, E],
    ``blocks`` (stacked), ``ln_f``, and ``unembed`` [E, V] unless the
    embeddings are tied. With a generator every parameter is drawn on
    its device in ``dtype`` (other values than ``jax.random``'s, at
    ``repro``'s scale); without one it is a structure to load into."""

    def __init__(self, cfg: LMConfig, generator=None, dtype=None):
        super().__init__()
        self.embed = L._dense_init((cfg.vocab, cfg.d_model), generator,
                                   dtype=dtype)
        self.blocks = Block(cfg, generator, dtype)
        self.ln_f = L.RMSNorm(cfg.d_model, (), generator, dtype)
        if not cfg.tie_embeddings:
            self.unembed = L._dense_init((cfg.d_model, cfg.vocab), generator,
                                         dtype=dtype)



def lm_axes(cfg: LMConfig) -> dict:
    """``repro``'s logical-axis tree of ``init_lm``: each stacked leaf
    leads with ``layers``."""
    from repro_torch.models.attention import attention_axes
    from repro_torch.models.moe import moe_axes
    layer = {"attn": attention_axes(cfg.attn_cfg()),
             "ffn": moe_axes(cfg.moe) if cfg.moe else L.swiglu_axes(),
             "ln1": L.rmsnorm_axes(), "ln2": L.rmsnorm_axes()}
    a = {"embed": ("vocab", "embed"),
         "blocks": tree_map(lambda ax: ("layers",) + ax, layer),
         "ln_f": {"scale": ("embed",)}}
    if not cfg.tie_embeddings:
        a["unembed"] = ("embed", "vocab")
    return a


def init_lm(cfg: LMConfig, seed: int = 0, device=None,
            dtype: torch.dtype = torch.float32) -> dict:
    """The parameter tree drawn on ``device`` (the card unless the caller
    names the CPU) from a ``torch.Generator`` seeded ``seed``, stored in
    ``dtype`` (bf16 at full size: 16.5 GB for granite-8b)."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        return L.params_tree(LM(cfg, gen, dtype))


def abstract_params(cfg: LMConfig):
    """The parameter tree on the ``meta`` device: shapes without
    storage."""
    with torch.device("meta"):
        return L.params_tree(LM(cfg))


def state_from_tree(tree, device=None) -> dict:
    """``repro``'s LM parameter tree (numpy arrays, stacked blocks) as the
    port's module state: the flat dotted dict ``LM.load_state_dict``
    takes, every tensor on ``device`` (the card unless the caller names
    the CPU)."""
    from repro_torch.core.sync import upload
    device = resolve_device(device)
    return {k: upload(np.asarray(v), device)
            for k, v in L.dotted(tree).items()}


def tree_from_state(state: dict) -> dict:
    """The inverse of ``state_from_tree``: the module state as
    ``repro``'s nested tree of numpy arrays."""
    from repro_torch.core.sync import host_arrays
    names = list(state)
    arrays = host_arrays(*(state[k] for k in names))
    return unflatten_paths((k.replace(".", "/"), np.asarray(a))
                           for k, a in zip(names, arrays))


# ------------------------------------------------------------------ forward
def token_rows(tokens, vocab: int) -> torch.Tensor:
    """Embedding rows of ``tokens`` as jnp's gather reads them: a negative
    id counts from the end, then ids are clamped to [0, V - 1] (ids past
    the end read row V - 1, ids below -V read row 0)."""
    t = tokens.long().clamp(-vocab, vocab - 1)
    return torch.where(t < 0, t + vocab, t)


def _whole(dist, tree):
    """``tree``'s parameters whole (``dist.whole``); as they are off a
    mesh."""
    return tree if dist is None else tree_map(dist.whole, tree)


def _embed(params, cfg: LMConfig, tokens, dtype, dist=None):
    """``params["embed"].astype(dtype)[tokens]``: the rows are gathered
    first, then cast (the same values, without a cast of the table). On
    a mesh each rank reads the rows of its vocabulary block, 0
    elsewhere, summed over ``model`` (the module docstring)."""
    rows = token_rows(tokens, cfg.vocab)
    if not SHD.tp(dist):
        return params["embed"].index_select(
            0, rows.reshape(-1)).to(dtype).view(*tokens.shape, cfg.d_model)
    w = dist.shard(params["embed"])
    lo, hi = _vocab_block(cfg, dist)
    flat = rows.reshape(-1) - lo
    mine = (flat >= 0) & (flat < hi - lo)
    vals = w.index_select(0, torch.where(mine, flat, 0))
    vals = torch.where(mine[:, None], vals, vals.new_zeros(()))
    return dist.from_model(vals.to(dtype)).view(*tokens.shape, cfg.d_model)


def _vocab_block(cfg: LMConfig, dist) -> tuple:
    """This rank's block ``(start, stop)`` of the vocabulary; a rank
    without one raises."""
    if any(a >= b for a, b in (dist.model_range(cfg.vocab, r)
                               for r in range(dist.model_size()))):
        raise ValueError(f"a vocabulary of {cfg.vocab} leaves a model rank "
                         "no row")
    return dist.model_range(cfg.vocab)


def _unembed(params, cfg: LMConfig, x, dtype, dist=None):
    """fp32 logits [..., V]; on a mesh this rank's vocabulary block."""
    x = L.rmsnorm(_whole(dist, params["ln_f"]), x)
    if SHD.tp(dist):
        w = dist.shard(params["embed"]).T if cfg.tie_embeddings else \
            dist.shard(params["unembed"])
        x = dist.to_model(x)
    else:
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ w.to(dtype)).to(torch.float32)


def _layers(params, n_layers: int, dist=None) -> list:
    """Each layer's parameters: every stacked leaf read once with
    ``unbind(0)`` (on a mesh, each layer's DTensors: ``dist.unstack``)."""
    unstack = (lambda a: a.unbind(0)) if dist is None else dist.unstack
    cols = tree_map(unstack, params["blocks"])
    return [tree_map(lambda c: c[i], cols) for i in range(n_layers)]


def _ffn(cfg: LMConfig, lp, x, dtype, dist=None):
    h = L.rmsnorm(_whole(dist, lp["ln2"]), x)
    if cfg.moe:
        return moe_ffn(lp["ffn"], cfg.moe, h, dtype=dtype, dist=dist)
    if SHD.tp(dist):
        w = {k: dist.shard(v) for k, v in lp["ffn"].items()}
        return dist.from_model(L.swiglu(w, dist.to_model(h), dtype)), None
    return L.swiglu(lp["ffn"], h, dtype), None


def _attn_in(lp, x, dist):
    """The layer's attention input: ``rmsnorm`` by ``ln1``."""
    return L.rmsnorm(_whole(dist, lp["ln1"]), x)


def _block(cfg: LMConfig, dtype, dist, lp, x):
    """One layer: ``x`` [B, S, E] -> (x, aux loss or None); each
    parameter read where it is used on a mesh (the module docstring)."""
    h, _ = causal_attention(lp["attn"], cfg.attn_cfg(),
                            _attn_in(lp, x, dist), q_chunk=cfg.q_chunk,
                            dtype=dtype, dist=dist)
    x = x + h
    f, a = _ffn(cfg, lp, x, dtype, dist)
    return x + f, a


# the ops whose outputs "dots" keeps (dots_saveable: every dot_general)
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default)


def _remat(cfg: LMConfig, block):
    """``block`` under ``cfg``'s remat policy while autograd records
    (``repro``'s ``jax.checkpoint`` of the layer), else ``block``."""
    if cfg.remat_policy not in ("none", "dots", "off"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}")
    if not (cfg.remat and cfg.remat_policy != "off"
            and torch.is_grad_enabled()):
        return block
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, list(DOT_OPS))
    return functools.partial(ckpt.checkpoint, block, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def _act_layouts(mesh):
    """(whole, sliced) placements of a [B, S, E] residual on this rank's
    batch shard: replicated, or the embed dim over ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    whole = tuple(Replicate() for _ in names)
    return whole, tuple(Shard(2) if a == "model" else Replicate()
                        for a in names)


def _sliced_block(block, mesh):
    """``block`` taking its input as this rank's ``model`` slice of the
    embed dim and returning its output sliced the same way."""
    from torch.distributed.tensor import DTensor
    whole, sliced = _act_layouts(mesh)

    def run(lp, x_slice):
        x = DTensor.from_local(x_slice, mesh, sliced, run_check=False) \
            .redistribute(mesh, whole).to_local()           # all-gather
        y, a = block(lp, x)
        return _slice(y, mesh), a
    return run


def _slice(x, mesh):
    from torch.distributed.tensor import DTensor
    whole, sliced = _act_layouts(mesh)
    return DTensor.from_local(x, mesh, whole, run_check=False) \
        .redistribute(mesh, sliced).to_local()              # a local chunk


def forward(params, cfg: LMConfig, tokens, dist=None):
    """tokens int[B, S] -> (logits f32[B, S, V], aux loss f32[]);
    ``dist``: the mesh call (the module docstring)."""
    dtype = compute_dtype(cfg)
    x = _embed(params, cfg, tokens, dtype, dist)
    aux = x.new_zeros((), dtype=torch.float32)
    block = functools.partial(_block, cfg, dtype, dist)
    mesh = dist.mesh if cfg.act_shard and dist is not None else None
    if mesh is not None:
        block, x = _sliced_block(block, mesh), _slice(x, mesh)
    block = _remat(cfg, block)
    for lp in _layers(params, cfg.n_layers, dist):
        x, a = block(lp, x)
        if a is not None:
            aux = aux + a
    if mesh is not None:
        whole, sliced = _act_layouts(mesh)
        from torch.distributed.tensor import DTensor
        x = DTensor.from_local(x, mesh, sliced, run_check=False) \
            .redistribute(mesh, whole).to_local()
    return _unembed(params, cfg, x, dtype, dist), aux


def lm_loss(params, cfg: LMConfig, tokens, targets, mask=None, dist=None):
    logits, aux = forward(params, cfg, tokens, dist)
    if SHD.tp(dist):
        loss = L.vocab_cross_entropy(logits, targets,
                                     _vocab_block(cfg, dist)[0], dist,
                                     cfg.vocab, impl=cfg.ce_impl)
    else:
        loss = L.softmax_cross_entropy(logits, targets, impl=cfg.ce_impl)
    if mask is not None:
        loss = torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        loss = torch.mean(loss)
    return loss + aux


# ------------------------------------------------------------------ serving
def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """``{"k", "v"}`` zeros [L, B, max_len, KV, Dh] and ``"len"`` int32[]
    on ``device`` (the card unless the caller names the CPU)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(params, cfg: LMConfig, tokens, max_len: int, dist=None):
    """Full-sequence forward that also fills the KV cache. tokens int[B,
    S], S <= max_len. Returns (logits f32[B, 1, V] at the last position,
    cache); on a mesh the logits' vocabulary block and the cache's block
    of positions (the module docstring)."""
    dtype = compute_dtype(cfg)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prefill of {s} tokens into a cache of {max_len}")
    x = _embed(params, cfg, tokens, dtype, dist)
    lo, hi = (0, max_len) if not SHD.tp(dist) else dist.model_range(max_len)
    cache = init_cache(cfg, b, hi - lo, dtype, tokens.device)
    stop = min(hi, s)
    acfg = cfg.attn_cfg()
    for i, lp in enumerate(_layers(params, cfg.n_layers, dist)):
        hn = _attn_in(lp, x, dist)
        h, (k, v) = causal_attention(lp["attn"], acfg, hn,
                                     q_chunk=cfg.q_chunk, dtype=dtype,
                                     dist=dist)
        if SHD.tp(dist):      # every rank reads (collectives), maybe none
            k, v = prefill_kv(lp["attn"], acfg, hn, (k, v), lo,
                              max(lo, stop), dtype, dist)
            cache["k"][i, :, :k.shape[1]] = k
            cache["v"][i, :, :v.shape[1]] = v
        else:
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        x = x + h
        x = x + _ffn(cfg, lp, x, dtype, dist)[0]
    cache["len"].fill_(s)
    return _unembed(params, cfg, x[:, -1:], dtype, dist), cache


def decode_step(params, cfg: LMConfig, cache, last_tokens, dist=None,
                max_len: int | None = None):
    """One-token decode. last_tokens int[B, 1]. Writes the cache in place;
    returns (logits f32[B, 1, V], cache). On a mesh ``cache`` is this
    rank's block of ``max_len`` positions and the logits its vocabulary
    block (the module docstring)."""
    dtype = compute_dtype(cfg)
    x = _embed(params, cfg, last_tokens, dtype, dist)
    for i, lp in enumerate(_layers(params, cfg.n_layers, dist)):
        h, _, _ = decode_attention(lp["attn"], cfg.attn_cfg(),
                                   _attn_in(lp, x, dist), cache["k"][i],
                                   cache["v"][i], cache["len"], dtype=dtype,
                                   dist=dist, max_len=max_len)
        x = x + h
        x = x + _ffn(cfg, lp, x, dtype, dist)[0]
    cache["len"].add_(1)
    return _unembed(params, cfg, x, dtype, dist), cache
