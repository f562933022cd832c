"""LR schedules (mirrors ``repro/optim/schedules.py``): pure functions of the
step counter, computed in f32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def cosine_warmup(lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warmup -> cosine decay to min_ratio * lr.  The schedule maps
    a step (int) to the learning rate as a 0-d f32 tensor on the CPU."""
    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                                 * prog))
        return torch.where(step < warmup_steps, warm, lr * cos)
    return schedule
