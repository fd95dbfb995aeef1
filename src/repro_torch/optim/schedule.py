"""LR schedules as step -> lr callables.

Mirrors `src/repro/optim/schedule.py` (`linear_warmup` :7,
`cosine_schedule` :14), computed in fp32 as the reference computes them,
and returned as a Python float holding that fp32 value.
"""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


def linear_warmup(base_lr: float, warmup_steps: int):
    def fn(step: int) -> float:
        frac = torch.clamp(_f32(step) / max(warmup_steps, 1), max=1.0)
        return float(_f32(base_lr) * frac)
    return fn


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step: int) -> float:
        s = _f32(step)
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(_f32(math.pi) * prog))
        return float(_f32(base_lr) * warm * cos)
    return fn
