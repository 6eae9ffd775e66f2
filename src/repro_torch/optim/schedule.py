"""Learning-rate schedules (the port's copy of ``repro.optim.schedule``).

Each takes the step as a host int or a 0-d tensor and returns a 0-d f32
tensor on the step's device (the CPU for a host int), computed in f32 as
the reference computes it in ``jnp``."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, total_steps: int, final_frac: float = 0.1):
    t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    return final_frac + (1.0 - final_frac) * 0.5 * (
        1.0 + torch.cos(math.pi * t))


def linear_warmup_cosine(step, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    s = _f32(step)
    warm = torch.clamp(s / max(warmup, 1), 0.0, 1.0)
    return warm * cosine_schedule(torch.clamp_min(s - warmup, 0.0),
                                  max(total_steps - warmup, 1), final_frac)
