"""LR schedules: pure functions of the step counter."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1
                    ) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio · peak_lr`` at ``total_steps``. ``step`` is an
    int or a tensor (the optimizer's count, read without a host sync);
    returns an f32 0-d tensor on its device."""
    step = (step.to(F32) if isinstance(step, torch.Tensor)
            else torch.tensor(float(step), dtype=F32))
    warm = peak_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
