"""Attention: projections, GQA repeat, blockwise flash attention, the
O(s·w) static sliding-window attention, single-step decode attention and
DeepSeek-V3's multi-head latent attention (MLA), mirroring
``repro.models.attention``.

``flash_attention`` here is the plain blockwise online-softmax form of the
reference, with its ``q_offset``, finite -1e30 mask value and 1e-30 clamp
of the denominator.  ``DecoderLM`` prefill does not call it: prefill goes
through ``repro_torch.kernels.flash_attention.ops``, whose CUDA kernel
computes the same function (``q_offset`` is 0 and ``sq == skv`` there, so
the two causal alignments agree).  Nor does it call
``sliding_window_attention``, which the reference's prefill takes for a
static window: K1's window mask is the same, so prefill sends the window
to K1, and ``sliding_window_attention`` is the O(s·w) yardstick that
K1's windowed output is held to at full width.  Decode attention is
plain torch, as it is plain jnp in the reference.  For Whisper's
cross-attention ``project_qkv`` takes k and v from another sequence
(``kv_x``), and ``init_attention(cross=True)`` draws no q/k norm scales.

MLA prefill (``mla_prefill``) is the reference's expanded form: k_nope
and v from the latent, the one-head k_rope broadcast to every head.  The
reference zero-pads v to the q·k head dim (192 at full width) and slices
o back to v's 128 columns; those columns do not depend on the zero ones,
and K1 takes v narrower than q and k as exactly that function, so v goes
to K1 unpadded and o comes back at v's width.  MLA decode
(``mla_decode``) is the reference's absorbed form against the latent
cache, in f32 throughout, plain torch as in the reference.  The multi-device
``mla_decode_sp`` comes with the multi-device layer (ROADMAP Queue 1
item 12).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L

NEG_INF = -1e30


def _softcap(x, cap):
    if cap == 0.0:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# params


def init_attention(generator, cfg, dtype, device, lead=(), cross=False):
    """wq, wk, wv, wo, and under ``cfg.qk_norm`` the q/k scales, which a
    cross-attention (``cross``: Whisper's decoder) has none of."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    kw = dict(lead=lead)
    p = {
        "wq": L.dense_init(generator, (d, nq * hd), dtype, device, **kw),
        "wk": L.dense_init(generator, (d, nkv * hd), dtype, device, **kw),
        "wv": L.dense_init(generator, (d, nkv * hd), dtype, device, **kw),
        "wo": L.dense_init(generator, (nq * hd, d), dtype, device, **kw),
    }
    if cfg.qk_norm and not cross:
        p["q_scale"] = torch.ones((*lead, hd), dtype=dtype, device=device)
        p["k_scale"] = torch.ones((*lead, hd), dtype=dtype, device=device)
    return p


def project_qkv(x, p, cfg, kv_x=None):
    """Returns q (b,s,nq,hd), k/v (b,skv,nkv,hd): k and v from ``kv_x``
    (b, skv, d) where given (cross-attention), else from x."""
    b, s, _ = x.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    kv_x = x if kv_x is None else kv_x
    q = (x @ p["wq"]).reshape(b, s, nq, hd)
    k = (kv_x @ p["wk"]).reshape(b, kv_x.shape[1], nkv, hd)
    v = (kv_x @ p["wv"]).reshape(b, kv_x.shape[1], nkv, hd)
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


def sliding_window_attention(q, k, v, *, window, softcap=0.0, block_q=512):
    """O(seq·window) attention for a static python-int window: each q
    block of ``block_q`` rows attends a kv slice of ``window + block_q``
    rows ending at the block's last row.  q (b,sq,h,hd), k/v
    (b,skv,h,hd) -> (b,sq,h,hd); scores and softmax in f32, output in
    q.dtype.  Masks: in range, causal, ``q_pos - k_pos < window``."""
    if not (isinstance(window, int) and window > 0):
        raise ValueError(f"window must be a positive int, got {window!r}")
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    nb = -(-sq // block_q)
    pad_q = nb * block_q - sq
    span = window + block_q
    # pad q's end, and kv's front (history) and end (q padding), so that
    # every slice has the same length
    q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, span, pad_q))
    vp = F.pad(v, (0, 0, 0, 0, span, pad_q))
    scale = 1.0 / math.sqrt(hd)
    blocks = []
    for i in range(nb):
        q0 = i * block_q
        start = q0 + block_q                 # in padded coordinates
        q_blk = q[:, q0:q0 + block_q].float() * scale
        k_blk = kp[:, start:start + span].float()
        v_blk = vp[:, start:start + span].float()
        q_pos = q0 + torch.arange(block_q, device=q.device)
        k_pos = start - span + torch.arange(span, device=q.device)
        s = _softcap(torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk), softcap)
        mask = ((k_pos[None, :] >= 0) & (k_pos[None, :] < skv)
                & (q_pos[:, None] >= k_pos[None, :])
                & (q_pos[:, None] - k_pos[None, :] < window))
        s = torch.where(mask, s, NEG_INF)
        blocks.append(torch.einsum("bhqk,bkhd->bqhd",
                                   torch.softmax(s, dim=-1), v_blk))
    return torch.cat(blocks, dim=1)[:, :sq].to(q.dtype)


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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): low-rank latent KV, absorbed decode


def init_mla(generator, cfg, dtype, device, lead=()):
    m, d, nq = cfg.mla, cfg.d_model, cfg.n_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim

    def dense(shape):
        return L.dense_init(generator, shape, dtype, device, lead=lead)

    def ones(n):
        return torch.ones((*lead, n), dtype=dtype, device=device)

    return {
        "wq_a": dense((d, m.q_lora_rank)),
        "q_norm": ones(m.q_lora_rank),
        "wq_b": dense((m.q_lora_rank, nq * qk_hd)),
        "wkv_a": dense((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": ones(m.kv_lora_rank),
        "wk_b": dense((m.kv_lora_rank, nq * m.qk_nope_head_dim)),
        "wv_b": dense((m.kv_lora_rank, nq * m.v_head_dim)),
        "wo": dense((nq * m.v_head_dim, d)),
    }


def _rms(x, scale, eps=1e-6):
    """MLA's own RMS norm, not ``layers.rmsnorm``: a fixed eps of 1e-6, a
    bare scale vector, one rounding to x's dtype at the end."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def mla_latents(x, p, cfg, positions):
    """The cached quantities: c_kv (b, s, r_kv) and k_rope (b, s, hd_r),
    k_rope rotated as one head with ``cfg.rope_theta``."""
    m = cfg.mla
    kv = x @ p["wkv_a"]
    c_kv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    c_kv = _rms(c_kv, p["kv_norm"])
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def mla_queries(x, p, cfg, positions):
    """(q_nope (b, s, h, hd_n), q_rope (b, s, h, hd_r))."""
    m, nq = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    q = _rms(x @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    q = q.reshape(b, s, nq, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = (q[..., :m.qk_nope_head_dim],
                      q[..., m.qk_nope_head_dim:])
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def mla_prefill(x, p, cfg, positions):
    """Expanded MLA for train and prefill, causal, through K1's
    dispatcher; returns (out (b, s, d), c_kv, k_rope)."""
    m, nq = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    c_kv, k_rope = mla_latents(x, p, cfg, positions)
    q_nope, q_rope = mla_queries(x, p, cfg, positions)
    k_nope = (c_kv @ p["wk_b"]).reshape(b, s, nq, m.qk_nope_head_dim)
    v = (c_kv @ p["wv_b"]).reshape(b, s, nq, m.v_head_dim)
    # contiguous in the head dim, as K1 takes them: the concatenation
    # materialises the broadcast k_rope
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, nq, m.qk_rope_head_dim)], dim=-1)
    # v at its own width: K1 computes the reference's padded call's first
    # v_head_dim columns
    o = flash_ops.flash_attention(q, k, v, causal=True)
    o = o.reshape(b, s, nq * m.v_head_dim)
    return o @ p["wo"], c_kv, k_rope


def mla_decode(x, p, cfg, c_kv_cache, k_rope_cache, length, positions):
    """Absorbed-matmul decode: the scores of q_nope · W_kb against the
    latent cache, never re-expanding per-position K/V, in f32; the output
    cast to x's dtype before ``wo``.  x (b, 1, d); ``length`` = number of
    valid cache slots."""
    m, nq = cfg.mla, cfg.n_heads
    b = x.shape[0]
    S = c_kv_cache.shape[1]
    q_nope, q_rope = mla_queries(x, p, cfg, positions)         # (b,1,h,.)
    wk_b = p["wk_b"].reshape(m.kv_lora_rank, nq, m.qk_nope_head_dim)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wk_b.float())
    ckv = c_kv_cache.float()
    s = torch.einsum("bqhr,bkr->bhqk", q_abs, ckv)
    s = s + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                         k_rope_cache.float())
    s = s * (1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    mask = torch.arange(S, device=x.device) < length
    pw = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", pw, ckv)
    wv_b = p["wv_b"].reshape(m.kv_lora_rank, nq, m.v_head_dim)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, wv_b.float())
    return o.reshape(b, 1, nq * m.v_head_dim).to(x.dtype) @ p["wo"]
