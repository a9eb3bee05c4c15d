"""LR schedules (multiplier-valued: pass as ``adamw(schedule=...)``), the
port's copy of ``repro.optim.schedule``. A schedule takes the step as a
tensor and returns a float32 tensor on its device, so the step reads
nothing back to the host."""
from __future__ import annotations

import math

import torch


def warmup_cosine(warmup_steps: int, total_steps: int, min_ratio=0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return warm * cos
    return fn


def constant():
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=step.device)
