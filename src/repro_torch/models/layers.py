"""Shared building blocks: norms, MLPs, rotary embeddings, initializers.

Plain functions on tensors and dicts of tensors, mirroring
``repro.models.layers``.  Params are stored in the config dtype (bf16 by
default); numerically sensitive reductions run in f32.  Where torch's
defaults differ from jax's, the jax behaviour is kept: tanh-approximate
GELU, population variance, RoPE over split halves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers (each draws from the caller's torch.Generator, which must
# live on ``device``)


def dense_init(generator, shape, dtype, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan_in))
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def embed_init(generator, shape, dtype, device):
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms


def init_norm(cfg, dtype, device):
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}


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


def init_mlp(generator, d_model, d_ff, act, dtype, device):
    p = {}
    if act in ("silu", "geglu"):
        p["gate"] = dense_init(generator, (d_model, d_ff), dtype, device)
    p["up"] = dense_init(generator, (d_model, d_ff), dtype, device)
    p["down"] = dense_init(generator, (d_ff, d_model), dtype, device)
    return p


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def apply_mlp(x, p, act):
    if "gate" in p:
        fn = F.silu if act == "silu" else _gelu
        h = fn(x @ p["gate"]) * (x @ p["up"])
    else:
        h = _gelu(x @ p["up"])
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
