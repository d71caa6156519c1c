"""LR schedules: functions of the step counter (counterpart of
repro.optim.schedule).

The counter is the optimizer's device tensor; the schedule computes on its
device in float32, as the reference does, and never reads it on the host
(one read a step would be a stream sync)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * torch.where(s < warmup, warm, cos)
    return lr
