"""Adafactor (Shazeer & Stern, arXiv:1804.04235) — factored second
moments: the port's copy of ``repro.optim.adafactor``. For an
``[a, b]`` matrix the state is a + b floats (``vr``, ``vc``) and no
first moment; a vector keeps a full ``v``. The parameters keep their
dtype: a bf16 parameter's update is ``repro``'s fp32 value rounded to
bf16 (``repro``'s own parameters turn fp32 after one step).
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import Optimizer, clip_by_global_norm, global_norm
from repro_torch.tree import tree_map


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip_norm=1.0,
              weight_decay=0.0, schedule=None) -> Optimizer:
    def init(params):
        def one(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return tree_map(one, params)

    def update(grads, state, params, step):
        if clip_norm:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = global_norm(grads)
        t = step.to(torch.float32) + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr if schedule is None else schedule(step) * lr

        def upd(p, g, s):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                rfac = vr / torch.clamp(
                    torch.mean(vr, dim=-1, keepdim=True), min=eps)
                prec = torch.rsqrt(torch.clamp(
                    rfac[..., None] * vc[..., None, :], min=eps))
                u = g * prec
                news = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp(v, min=eps))
                news = {"v": v}
            # update-norm clipping (Adafactor's d=1.0 rule, simplified)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms, min=1.0)
            # repro's lr_t is a strongly typed fp32 scalar, so with bf16
            # parameters its product and difference are fp32 (and repro's
            # parameters turn fp32 after a step). The same fp32 value here,
            # rounded back: the state keeps the parameter dtype.
            newp = p - lr_t * (u + weight_decay * p).to(p.dtype).to(
                torch.float32)
            return newp.to(p.dtype), news

        # tree_map walks the params: at each leaf the state's subtree
        # ({"vr", "vc"} or {"v"}) comes along whole
        outs = tree_map(upd, params, grads, state)
        return (tree_map(lambda o: o[0], outs),
                tree_map(lambda o: o[1], outs), gnorm)

    return Optimizer(init=init, update=update)
