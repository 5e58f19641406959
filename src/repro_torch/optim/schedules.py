"""LR schedules: constant, cosine, and WSD (warmup-stable-decay, the
minicpm-2b schedule, [arXiv:2404.06395]). The port of
``repro/optim/schedules.py``.

Each schedule maps a round to its learning rate as an f32 0-dim tensor,
computed in f32 tensor arithmetic as the reference's ``jnp`` code is (a
Python float would round differently). The round may be an int or an
integer tensor on a device: a captured CUDA graph passes its round buffer
and gets the rate on the device, read from the buffer at replay.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["constant", "cosine", "wsd", "get"]

Schedule = Callable[[int | torch.Tensor], torch.Tensor]


def _step(step: int | torch.Tensor) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def constant(lr: float) -> Schedule:
    def fn(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), lr, dtype=torch.float32, device=dev)  # a fill: capturable

    return fn


def cosine(lr: float, total_steps: int, *, warmup: int = 0, final_frac: float = 0.1) -> Schedule:
    def fn(step):
        step = _step(step)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return lr * warm * cos

    return fn


def wsd(lr: float, total_steps: int, *, warmup_frac: float = 0.01,
        decay_frac: float = 0.1) -> Schedule:
    """Warmup-Stable-Decay: linear warmup, long flat stage, short exponential
    decay tail (the last ``decay_frac`` of training), per MiniCPM."""
    warmup = max(1, int(warmup_frac * total_steps))
    decay_start = int((1.0 - decay_frac) * total_steps)

    def fn(step):
        step = _step(step)
        warm = torch.clamp(step / warmup, max=1.0)
        in_decay = torch.clamp(step - decay_start, min=0.0)
        span = max(total_steps - decay_start, 1)
        decay = torch.pow(10.0, -2.0 * in_decay / span)  # 100x down over the tail
        return lr * warm * decay

    return fn


def get(name: str, lr: float, total_steps: int) -> Schedule:
    if name == "const":
        return constant(lr)
    if name == "cosine":
        return cosine(lr, total_steps)
    if name == "wsd":
        return wsd(lr, total_steps)
    raise ValueError(f"unknown schedule {name!r}")
