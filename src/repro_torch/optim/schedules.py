"""LR schedules: cosine, linear, and WSD (warmup-stable-decay, MiniCPM),
the port of ``repro.optim.schedules``.

Each returns a 0-d float32 tensor on ``step``'s device, computed in f32
op by op as the jnp versions are: a Python float meets an f32 tensor as
an f32 (JAX's weak typing), and expressions of Python floats alone are
folded in double first, as in the reference."""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


def cosine(step, *, peak_lr, warmup, total, final_frac=0.1):
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    decay = final_frac + (1 - final_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, peak_lr * decay)


def wsd(step, *, peak_lr, warmup, stable, decay, final_frac=0.01):
    """MiniCPM warmup-stable-decay: linear warmup -> flat -> exp decay."""
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup - stable) / max(decay, 1), 0, 1)
    log_frac = torch.log(torch.tensor(final_frac, dtype=torch.float32,
                                      device=step.device))
    dec = peak_lr * torch.exp(log_frac * t)
    peak = torch.full_like(step, peak_lr)
    return torch.where(step < warmup, warm,
                       torch.where(step < warmup + stable, peak, dec))


def linear(step, *, peak_lr, warmup, total):
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    return torch.where(step < warmup, warm, peak_lr * (1 - prog))


def make_schedule(name, **kw):
    return {"cosine": cosine, "wsd": wsd, "linear": linear}[name], kw
