"""Shared layers: the part of ``repro.models.layers`` that the GNNs use,
as ``nn.Module``s.

A module's parameter names are the paths of ``repro``'s parameter tree
joined by dots (``Linear``: ``w``, ``b``; ``MLP``: ``l0.w``, ``l0.b``,
...), so carrying weights between the packages is a rename of ``/`` to
``.`` (``params_tree``, ``dotted``), not a table. ``repro``'s logical
sharding axes (the second tree its ``init_*`` return) are the
``*_axes`` functions: trees of axis-name tuples with the parameter
tree's structure, which ``distributed/sharding.py`` maps onto a mesh.

The LM layers (RMSNorm, LayerNorm, SwiGLU, RoPE) keep ``repro``'s casts:
``rmsnorm`` takes the mean square in fp32 and multiplies in ``x``'s
dtype, ``apply_rope`` rotates in fp32 by promotion and casts back once,
``swiglu`` runs in ``dtype``. Their modules take a leading ``lead``
shape: the LM stacks its layers' parameters on a leading axis, as
``repro`` does (``blocks.ln1.scale`` is ``[L, E]``).
``vocab_cross_entropy`` is ``softmax_cross_entropy`` over logits split
by vocabulary over a mesh's ``model`` axis.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.tree import flatten_with_paths, unflatten_paths


def _dense_init(shape, generator=None, in_axis=-2, dtype=None) -> nn.Parameter:
    """N(0, 1) / sqrt(fan_in), drawn from ``generator``; without one the
    parameter is left uninitialised (a structure to be loaded into, or
    to pass to ``torch.func.functional_call``).

    With a ``dtype`` (the LM's stacked weights) the parameter is
    allocated in that dtype on the generator's device and drawn into in
    row blocks of at most ``_DRAW_BLOCK`` fp32 values, so a full-size
    ``[36, 4096, 14336]`` bf16 tensor never exists in fp32 whole."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype))
    if dtype is None:
        return nn.Parameter(torch.randn(shape, generator=generator)
                            / math.sqrt(shape[in_axis]))
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    rows = out.view(-1, shape[-1])
    step = max(1, _DRAW_BLOCK // shape[-1])
    scale = math.sqrt(shape[in_axis])
    for r in range(0, rows.shape[0], step):
        blk = rows[r:r + step]
        blk.copy_(torch.randn(blk.shape, generator=generator,
                              device=generator.device) / scale)
    return nn.Parameter(out)


_DRAW_BLOCK = 1 << 27        # fp32 values drawn at once (512 MB)


class Linear(nn.Module):
    def __init__(self, d_in, d_out, bias=False, generator=None):
        super().__init__()
        self.w = _dense_init((d_in, d_out), generator)
        if bias:
            self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        y = x @ self.w
        if hasattr(self, "b"):
            y = y + self.b
        return y


def linear_axes(axes=("embed", "mlp"), bias=False) -> dict:
    a = {"w": tuple(axes)}
    if bias:
        a["b"] = (axes[1],)
    return a


def mlp_axes(n_layers: int, axes_prefix="mlp", bias=True,
             final_bias=True) -> dict:
    """``MLP``'s axes: ``l{i}`` with ``(<prefix>_in, <prefix>_out)``."""
    return {f"l{i}": linear_axes(
        (f"{axes_prefix}_in", f"{axes_prefix}_out"),
        bias if i < n_layers - 1 else final_bias) for i in range(n_layers)}


def rmsnorm_axes(axis="embed") -> dict:
    return {"scale": (axis,)}


def layernorm_axes(axis="embed") -> dict:
    return {"scale": (axis,), "bias": (axis,)}


def swiglu_axes() -> dict:
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


class MLP(nn.Module):
    """Plain MLP tower (``repro``'s ``init_mlp``/``mlp``): layers ``l0``,
    ``l1``, ..., the activation between them, none after the last."""

    def __init__(self, dims, bias=True, final_bias=True, generator=None):
        super().__init__()
        self.n = len(dims) - 1
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            use_b = bias if i < len(dims) - 2 else final_bias
            setattr(self, f"l{i}", Linear(din, dout, use_b, generator))

    def forward(self, x, act=torch.relu):
        for i in range(self.n):
            x = getattr(self, f"l{i}")(x)
            if i < self.n - 1:
                x = act(x)
        return x


def _fill(shape, value: float, generator=None, dtype=None):
    """A constant parameter (norm scales, biases) on the generator's
    device, or uninitialised without a generator."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype))
    return nn.Parameter(torch.full(shape, value, dtype=dtype or torch.float32,
                                   device=generator.device))


class RMSNorm(nn.Module):
    """``repro``'s ``init_rmsnorm``: ``scale`` ones [*lead, d]."""

    def __init__(self, d, lead=(), generator=None, dtype=None):
        super().__init__()
        self.scale = _fill((*lead, d), 1.0, generator, dtype)


def rmsnorm(p, x, eps=1e-6):
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"].to(x.dtype)


def layernorm(p, x, eps=1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


class SwiGLU(nn.Module):
    """``repro``'s ``init_swiglu``: ``w_gate``, ``w_up`` [*lead, d_model,
    d_ff] and ``w_down`` [*lead, d_ff, d_model]."""

    def __init__(self, d_model, d_ff, lead=(), generator=None, dtype=None):
        super().__init__()
        self.w_gate = _dense_init((*lead, d_model, d_ff), generator,
                                  dtype=dtype)
        self.w_up = _dense_init((*lead, d_model, d_ff), generator, dtype=dtype)
        self.w_down = _dense_init((*lead, d_ff, d_model), generator,
                                  dtype=dtype)


def swiglu(p, x, dtype=torch.bfloat16):
    g = x @ p["w_gate"].to(dtype)
    u = x @ p["w_up"].to(dtype)
    return (torch.nn.functional.silu(g) * u) @ p["w_down"].to(dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., S, H, Dh]; positions: broadcastable [..., S] (a device
    tensor at decode: the cache length)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)               # [Dh/2]
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, Dh/2]
    cos = torch.cos(ang)[..., None, :]                    # [..., S, 1, Dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def target_index(labels, vocab: int) -> tuple:
    """``(ok, idx)``: the labels read by ``jnp.take_along_axis``'s rule
    over a last dim of ``vocab`` (``models/embedding.lookup``'s rule for
    rows). A label in [-vocab, 0) counts from the end; ``ok`` is False
    for a label past either end (its logit reads NaN), whose ``idx``
    (every label modulo ``vocab``) the caller masks."""
    t = labels.long()
    return (t >= -vocab) & (t < vocab), torch.remainder(t, vocab)


def softmax_cross_entropy(logits, labels, z_loss: float = 0.0,
                          impl: str = "gather"):
    """logits [..., V]; labels int [...]. Returns the per-token loss.

    ``impl="gather"`` reads the label logit by ``jnp.take_along_axis``'s
    rule (``target_index``: a label in [-V, 0) wraps, one past either end
    gives a NaN loss) with ``torch.gather``; ``impl="iota"`` selects it
    with an iota compare and a sum (``repro``'s vocabulary-sharding-safe
    form; the same arithmetic on one card, and lse for a label outside
    [0, V), as in ``repro``)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    if impl == "iota":
        iota = torch.arange(logits.shape[-1], device=logits.device)
        onehot = labels[..., None].long() == iota
        ll = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    else:
        ok, idx = target_index(labels, logits.shape[-1])
        ll = torch.gather(logits, -1, idx[..., None])[..., 0]
        ll = torch.where(ok, ll, float("nan"))
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss


def vocab_cross_entropy(logits, labels, start: int, dist, vocab: int,
                        z_loss: float = 0.0, impl: str = "gather"):
    """``softmax_cross_entropy`` of logits whose last dim is this rank's
    block ``[start, start + n)`` of a vocabulary of ``vocab`` (``dist``: a
    tensor-parallel ``distributed.sharding.ModelCall``; no rank holds
    [..., V] whole).

    Each rank takes its block's ``logsumexp``; the max of those over the
    ``model`` ranks (no gradient), the sum of their exponentials
    relative to it, and the target's logit (read by the rank whose block
    holds it, 0 elsewhere) are all-reduced over ``model``. ``"gather"``
    maps the labels by ``target_index`` first, so a wrapped label is
    read by the rank that holds it and one past either end gives NaN on
    every rank. On one rank the arithmetic is ``softmax_cross_entropy``'s
    (the block's lse plus log 1)."""
    logits = logits.to(torch.float32)
    part = torch.logsumexp(logits, dim=-1)
    top = dist.max_over_model(part)
    lse = top + torch.log(dist.from_model(torch.exp(part - top)))
    n = logits.shape[-1]
    if impl == "iota":
        local = labels.long() - start
        iota = torch.arange(n, device=logits.device)
        ll = dist.from_model(torch.sum(
            torch.where(local[..., None] == iota, logits, 0.0), dim=-1))
    else:
        ok, idx = target_index(labels, vocab)
        local = idx - start
        mine = (local >= 0) & (local < n)
        ll = torch.gather(logits, -1,
                          torch.where(mine, local, 0)[..., None])[..., 0]
        ll = dist.from_model(torch.where(mine, ll, 0.0))
        ll = torch.where(ok, ll, float("nan"))
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss


def params_tree(module: nn.Module) -> dict:
    """The module's parameters as ``repro``'s nested tree (detached)."""
    return unflatten_paths((name.replace(".", "/"), p.detach())
                           for name, p in module.named_parameters())


def dotted(tree) -> dict:
    """A parameter tree as the flat ``{"phi_e0.l0.w": tensor}`` dict that
    ``load_state_dict`` and ``torch.func.functional_call`` take."""
    return {path.replace("/", "."): leaf
            for path, leaf in flatten_with_paths(tree)}
