"""LR schedules: functions of the optimizer's int32 step tensor that return
a float32 0-d tensor on the step's device, computed in float32 in the
reference's order of operations."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, min_ratio: float = 0.1):
    def fn(step):
        t = torch.clamp_max(_f32(step), total_steps) / total_steps
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (min_ratio + (1 - min_ratio) * cos)

    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_ratio: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_ratio)

    def fn(step):
        step = torch.as_tensor(step)
        warm = base_lr * _f32(step) / max(warmup, 1)
        return torch.where(step < warmup, warm, cos(step - warmup))

    return fn
