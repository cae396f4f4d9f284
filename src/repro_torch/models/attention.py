"""Attention, dense GQA part: projections, GQA repeat, blockwise flash
attention and single-step decode attention, mirroring
``repro.models.attention``.

``flash_attention`` here is the plain blockwise online-softmax form of the
reference, with its ``q_offset``, finite -1e30 mask value and 1e-30 clamp
of the denominator.  ``DecoderLM`` prefill does not call it: prefill goes
through ``repro_torch.kernels.flash_attention.ops``, whose CUDA kernel
computes the same function (``q_offset`` is 0 and ``sq == skv`` there, so
the two causal alignments agree).  Decode attention is plain torch, as it
is plain jnp in the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L

NEG_INF = -1e30


def _softcap(x, cap):
    if cap == 0.0:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# params


def init_attention(generator, cfg, dtype, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": L.dense_init(generator, (d, nq * hd), dtype, device),
        "wk": L.dense_init(generator, (d, nkv * hd), dtype, device),
        "wv": L.dense_init(generator, (d, nkv * hd), dtype, device),
        "wo": L.dense_init(generator, (nq * hd, d), dtype, device),
    }
    if cfg.qk_norm:
        p["q_scale"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_scale"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def project_qkv(x, p, cfg):
    """Returns q (b,s,nq,hd), k/v (b,s,nkv,hd)."""
    b, s, _ = x.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(b, s, nq, hd)
    k = (x @ p["wk"]).reshape(b, s, nkv, hd)
    v = (x @ p["wv"]).reshape(b, s, nkv, hd)
    if "q_scale" in p:
        q = L.head_rmsnorm(q) * p["q_scale"]
        k = L.head_rmsnorm(k) * p["k_scale"]
    return q, k, v


def repeat_kv(k, n_heads):
    nkv = k.shape[2]
    if nkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // nkv, dim=2)


# ---------------------------------------------------------------------------
# blockwise flash attention (plain torch, loop over KV blocks)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0, block_kv=1024, mask_value=NEG_INF):
    """q (b,sq,h,hd), k/v (b,skv,h,hd) -> (b,sq,h,hd).

    ``window`` is a python int (0 = none); ``q_offset`` is the absolute
    position of q[0] (chunked prefill)."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf = (q.float() * scale).transpose(1, 2)                   # b h sq hd
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    q_pos = q_offset + torch.arange(sq, device=q.device)

    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for start in range(0, skv, block_kv):
        kblk = kf[:, :, start:start + block_kv]
        vblk = vf[:, :, start:start + block_kv]
        k_pos = start + torch.arange(kblk.shape[2], device=q.device)
        s = _softcap(qf @ kblk.transpose(-1, -2), softcap)
        mask = torch.ones((sq, k_pos.shape[0]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window > 0:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        s = torch.where(mask, s, mask_value)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vblk
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(q, k_cache, v_cache, length, *, window=0, softcap=0.0):
    """Single-step decode.  q (b,1,h,hd); caches (b,S,h,hd).  ``length`` =
    number of valid cache entries (new token already written at
    length-1)."""
    hd = q.shape[-1]
    S = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k_cache.float())
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=q.device)
    mask = pos < length
    if window > 0:
        mask &= pos >= length - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v_cache.float())
    return out.to(q.dtype)
