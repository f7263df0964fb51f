"""LR schedules as pure functions of the step, in float32 arithmetic as the
reference's (``repro.optim.schedule``) on its traced int32 step."""
from __future__ import annotations

import numpy as np

f32 = np.float32


def linear_warmup(step: int, base_lr: float, warmup_steps: int) -> np.float32:
    return f32(base_lr) * np.minimum(f32(1.0), f32(step + 1) / f32(max(warmup_steps, 1)))


def cosine_schedule(step: int, base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> np.float32:
    if step < warmup_steps:
        return linear_warmup(step, base_lr, warmup_steps)
    frac = np.clip(f32(step - warmup_steps) / f32(max(total_steps - warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(min_ratio) + f32((1 - min_ratio) * 0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac))
    return f32(base_lr) * cos
