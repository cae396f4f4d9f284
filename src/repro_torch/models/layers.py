"""Shared building blocks: norms, MLPs, rotary embeddings, initializers.

Plain functions on tensors and dicts of tensors, mirroring
``repro.models.layers``.  Params are stored in the config dtype (bf16 by
default); numerically sensitive reductions run in f32.  Where torch's
defaults differ from jax's, the jax behaviour is kept: tanh-approximate
GELU, population variance, RoPE over split halves.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers (each draws from the caller's torch.Generator, which must
# live on ``device``)


# Drawn in row blocks of at most DRAW_BLOCK elements, straight into the
# tensor's storage in ``dtype``, so that no f32 copy of a whole large
# tensor exists (a stacked (E, d, d_e) expert weight of Jamba-1.5-Large
# is 12.9 GB in f32).  A tensor of at most DRAW_BLOCK elements is one
# block, the same draw as one ``torch.randn`` of its shape.
DRAW_BLOCK = 1 << 28


def _normal(generator, shape, std, dtype, device):
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:                  # shapes alone (``DecoderLM.layout``)
        return out
    rows = out.view(-1, shape[-1])
    step = max(1, DRAW_BLOCK // shape[-1])
    for r0 in range(0, rows.shape[0], step):
        blk = rows[r0:r0 + step]
        blk.copy_(torch.randn(blk.shape, generator=generator, device=device,
                              dtype=torch.float32).mul_(std))
    return out


def dense_init(generator, shape, dtype, device, fan_in=None, lead=()):
    """N(0, 1/fan_in) of ``(*lead, *shape)``; ``fan_in`` defaults to
    ``shape[0]``.  ``lead`` stacks independent draws on leading dims, as
    the reference's vmapped initialisers do."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return _normal(generator, (*lead, *shape),
                   1.0 / math.sqrt(max(1, fan_in)), dtype, device)


def embed_init(generator, shape, dtype, device):
    return _normal(generator, shape, 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms


def init_norm(cfg, dtype, device, lead=()):
    return {"scale": torch.ones((*lead, cfg.d_model), dtype=dtype,
                                device=device)}


def rmsnorm(x, params, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def layernorm(x, params, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def apply_norm(x, params, cfg):
    if cfg.norm == "layernorm":
        return layernorm(x, params, cfg.norm_eps)
    return rmsnorm(x, params, cfg.norm_eps)


def head_rmsnorm(x, eps=1e-6):
    """Parameter-free per-head RMS norm (qk_norm)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated or plain)


def init_mlp(generator, d_model, d_ff, act, dtype, device, lead=()):
    p = {}
    if act in ("silu", "geglu"):
        p["gate"] = dense_init(generator, (d_model, d_ff), dtype, device,
                               lead=lead)
    p["up"] = dense_init(generator, (d_model, d_ff), dtype, device,
                         lead=lead)
    p["down"] = dense_init(generator, (d_ff, d_model), dtype, device,
                           lead=lead)
    return p


def silu(x):
    """``jax.nn.silu`` as the reference computes it: x * (1 / (1 +
    exp(-x))), each op rounded to x's dtype.  In bf16, ``F.silu``'s single
    rounding differs from that in many elements; in f32 the two differ
    in the last ulp, so f32 takes ``F.silu``'s one kernel."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))


@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype):
    """sqrt(2 / pi) and 0.044715 rounded to ``dtype``, as Python floats:
    a scalar that ``dtype`` holds exactly, times a tensor of ``dtype``,
    rounds as the product of two such tensors does, and costs no copy to
    the device."""
    return tuple(torch.tensor(c, dtype=dtype).item()
                 for c in (math.sqrt(2 / math.pi), 0.044715))


def gelu(x):
    """``jax.nn.gelu`` (its default tanh form) as the reference computes
    it: x * (0.5 * (1 + tanh(c * (x + k * (x * x * x))))), each op
    rounded to x's dtype, with c = sqrt(2 / pi) and k = 0.044715 rounded
    to x's dtype first (JAX's weakly typed constants take the array's
    dtype).  In bf16, ``F.gelu``'s single rounding differs from that in
    many elements; in f32 the two differ in the last ulp, so f32 takes
    ``F.gelu``'s one kernel."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c, k = _gelu_constants(x.dtype)
    inner = c * (x + k * (x * x * x))
    return x * (0.5 * (1 + torch.tanh(inner)))


def apply_mlp(x, p, act):
    if "gate" in p:
        fn = silu if act == "silu" else gelu
        h = fn(x @ p["gate"]) * (x @ p["up"])
    else:
        h = gelu(x @ p["up"])
    return h @ p["down"]


# ---------------------------------------------------------------------------
# rotary position embeddings


def apply_rope(x, positions, theta):
    """x: (..., seq, n_heads, head_dim); positions: (..., seq) int.
    ``theta`` is a python float (per-layer for gemma3's interleave).
    Rotates the two halves of each head, not interleaved pairs."""
    head_dim = x.shape[-1]
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=x.device) / head_dim
    # theta rounded to f32 on the host, as jnp.asarray(theta, f32)
    theta32 = torch.tensor(theta, dtype=torch.float32).item()
    inv = torch.pow(theta32, -exponent)                      # (hd/2,)
    angles = positions[..., None].float() * inv              # (..., s, hd/2)
    angles = angles[..., None, :]                            # (..., s, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# sinusoidal positions (Whisper)


def sinusoidal_positions(n_pos, d_model, device):
    """The (n_pos, d_model) f32 table of sin then cos of pos / 10000^(2i /
    d_model): computed in numpy f64 and cast to f32, as the reference
    does, so its bits equal the reference's.  One table a (n_pos,
    d_model, device), shared by every caller (read it, never write it):
    a decode step then makes no host-to-device copy, which would hold the
    host until the card drained."""
    return _sinusoidal_table(int(n_pos), int(d_model), torch.device(device))


@functools.lru_cache(maxsize=64)
def _sinusoidal_table(n_pos, d_model, device):
    pos = np.arange(n_pos)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d_model)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# losses


def softmax_xent(logits, labels, mask=None):
    """logits (..., V) f32-upcast cross entropy; labels int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
