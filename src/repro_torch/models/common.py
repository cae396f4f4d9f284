"""Shared LM plumbing: embeddings, heads, residual scaling."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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
    # the reference's jnp.take; F.embedding's CUDA backward sums the rows
    # of repeated tokens after a sort, with no atomics, so a training step
    # gives the same bits each time (chip_smoke.py checks it on the card)
    x = F.embedding(tokens.long(), p["tokens"])
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


# ---------------------------------------------------------------------------
# per-layer params stacked on a leading (L, ...) dim, as the reference's
# vmapped init and lax.scan over layers keep them


def index_layer(tree, l):
    """Layer ``l``'s params as views of the stacked tensors."""
    return {k: index_layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def unstack_layers(tree, n):
    """Every layer's params as views of the stacked tensors, a list of
    ``n`` trees.  One ``unbind`` per leaf: its backward stacks the
    layers' gradients into the stacked leaf once, where ``index_layer``'s
    views would each add a zero-filled copy of the whole leaf."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = unstack_layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for l in range(n):
            out[l][k] = parts[l]
    return out
