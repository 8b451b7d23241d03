"""LR schedules, the port of `repro.train.schedules`: cosine (default) and
WSD (Warmup-Stable-Decay, the minicpm-2b training schedule
[arXiv:2404.06395]: a constant plateau with a short exponential-ish decay
tail, which allows continuous pretraining).  Both compute in f32 in the
reference's order of operations, so warmup and the plateau are equal to
the reference's bit for bit; `cos` and `pow` may differ by an ulp.  A step
on the card gives the rate on the card."""
from __future__ import annotations

import math

import torch


def _t(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def cosine(step, *, peak_lr: float, warmup: int, total: int,
           min_ratio: float = 0.1) -> torch.Tensor:
    t = _t(step)
    warm = peak_lr * t / max(warmup, 1)
    frac = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(t < warmup, warm, cos)


def wsd(step, *, peak_lr: float, warmup: int, total: int,
        decay_fraction: float = 0.1, min_ratio: float = 0.01
        ) -> torch.Tensor:
    """Warmup -> stable plateau -> decay over the last `decay_fraction`."""
    t = _t(step)
    decay_steps = decay_fraction * total
    decay_start = total - decay_steps
    warm = peak_lr * t / max(warmup, 1)
    frac = torch.clamp((t - decay_start) / max(decay_steps, 1), 0.0, 1.0)
    decay = peak_lr * torch.pow(min_ratio, frac)
    out = torch.where(t < warmup, warm, peak_lr)
    return torch.where(t > decay_start, decay, out)


def make(name: str, **kw):
    fn = {"cosine": cosine, "wsd": wsd}[name]
    return lambda step: fn(step, **kw)
