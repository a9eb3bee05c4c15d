"""Shared layers: the part of ``repro.models.layers`` that the GNNs use,
as ``nn.Module``s.

A module's parameter names are the paths of ``repro``'s parameter tree
joined by dots (``Linear``: ``w``, ``b``; ``MLP``: ``l0.w``, ``l0.b``,
...), so carrying weights between the packages is a rename of ``/`` to
``.`` (``params_tree``, ``dotted``), not a table. ``repro``'s logical
sharding axes have no counterpart on one card. The norms, SwiGLU and
RoPE come with the LM slice.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.tree import flatten_with_paths, unflatten_paths


def _dense_init(shape, generator=None, in_axis=-2) -> nn.Parameter:
    """N(0, 1) / sqrt(fan_in), drawn from ``generator``; without one the
    parameter is left uninitialised (a structure to be loaded into, or
    to pass to ``torch.func.functional_call``)."""
    if generator is None:
        return nn.Parameter(torch.empty(shape))
    return nn.Parameter(torch.randn(shape, generator=generator)
                        / math.sqrt(shape[in_axis]))


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


def softmax_cross_entropy(logits, labels):
    """logits [..., V]; labels int [...]. Returns the per-token loss
    (``repro``'s ``impl="gather"`` without ``z_loss``: the GNNs use
    neither the z-loss nor the ``"iota"`` form for vocabulary
    sharding)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - ll


def params_tree(module: nn.Module) -> dict:
    """The module's parameters as ``repro``'s nested tree (detached)."""
    return unflatten_paths((name.replace(".", "/"), p.detach())
                           for name, p in module.named_parameters())


def dotted(tree) -> dict:
    """A parameter tree as the flat ``{"phi_e0.l0.w": tensor}`` dict that
    ``load_state_dict`` and ``torch.func.functional_call`` take."""
    return {path.replace("/", "."): leaf
            for path, leaf in flatten_with_paths(tree)}
