"""LR schedules: callables of the int step returning an fp32 0-dim tensor.
Port of ``repro/optim/schedules.py``."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    def sched(step):
        s = torch.tensor(float(step), dtype=torch.float32)
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return sched
