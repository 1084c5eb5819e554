"""Learning-rate schedules. Port of ``repro/optim/schedule.py``: float32
arithmetic on 0-d tensors, as the reference's traced schedule."""
from __future__ import annotations

import math
from typing import Union

import torch

Step = Union[int, torch.Tensor]


def warmup_cosine(step: Step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to peak, cosine decay to floor*peak (a 0-d float32
    tensor on the CPU)."""
    s = torch.as_tensor(step, dtype=torch.float32)
    # (s+1)/W so the FIRST step trains (an optimizer step at lr exactly 0
    # silently wastes the step and breaks single-step smoke tests)
    warm = (s + 1.0) / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)


def constant(step: Step, *, lr: float) -> torch.Tensor:
    """``lr`` at every step (a 0-d float32 tensor on the CPU)."""
    return torch.full((), lr, dtype=torch.float32)
