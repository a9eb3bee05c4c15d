"""AdamW with global-norm clipping: the port's copy of
``repro.optim.adamw``, with ``repro``'s arithmetic (not
``torch.optim.AdamW``'s).

An ``Optimizer`` is a pair of functions over trees of tensors
(``repro_torch.tree``): ``init(params) -> state`` and ``update(grads,
state, params, step) -> (new_params, new_state, gnorm)``. ``update``
returns new tensors and leaves its arguments alone, so a caller that
drops the result still holds the state from before the step. The state
keeps ``repro``'s names (``mu``/``nu``; Adafactor's ``vr``/``vc``/``v``),
so a checkpoint of either package names the same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable      # (grads, state, params, step) -> (params, state, gnorm)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw(lr=1e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          clip_norm=1.0, schedule=None) -> Optimizer:
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, step):
        if clip_norm:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = global_norm(grads)
        t = step.to(torch.float32) + 1.0
        lr_t = lr if schedule is None else schedule(step) * lr
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                      state["nu"], grads)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(p, m, v):
            step_ = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return p - lr_t * (step_ + weight_decay * p)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu}, gnorm

    return Optimizer(init=init, update=update)
