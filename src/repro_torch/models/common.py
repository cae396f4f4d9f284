"""Shared LM plumbing: embeddings, heads, residual scaling."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L


def init_embedding(generator, cfg, dtype, device):
    p = {"tokens": L.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                dtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                    dtype, device)
    return p


def mul_scalar(x, scale):
    """x * scale with the scale first rounded to x's dtype, as
    jnp.asarray(scale, x.dtype) does.  The rounding happens on the host:
    a scalar tensor made on the card per call would wait for the card."""
    if scale == 1.0:
        return x
    return x * torch.tensor(scale, dtype=x.dtype).item()


def embed(tokens, p, cfg):
    x = p["tokens"][tokens.long()]
    if cfg.emb_scale != 1.0:
        x = mul_scalar(x, cfg.emb_scale)
    return x


def lm_logits(x, p, cfg):
    if cfg.logit_scale != 1.0:
        x = mul_scalar(x, cfg.logit_scale)
    w = p["tokens"].T if cfg.tie_embeddings else p["lm_head"]
    return x @ w


def residual_scale(cfg) -> float:
    """depth_scale / sqrt(L), computed in f32 like the reference."""
    if cfg.depth_scale:
        return float(np.float32(cfg.depth_scale)
                     / np.sqrt(np.float32(cfg.n_layers)))
    return 1.0
