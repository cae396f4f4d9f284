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
cache, in f32 throughout, plain torch as in the reference.

On a mesh (``distribution/context.py``) each rank holds its shard of the
weights, and these functions take the shard's widths from the weights
themselves: q from ``wq``'s (or MLA's ``wq_b``'s) columns holds this
rank's heads, ``repeat_kv`` gives each local q head its kv head, MLA's
column-split down-projections are all-gathered over `model` before their
norms, and ``out_proj`` sums the heads' partial products over `model`.
For training, every value that each rank holds whole and that enters
the local heads' computation is marked by ``comm.enter`` (its gradient
psum'd over `model`: ``collectives.py``): x before the column-split
projections, the q/k norm scales, the GQA k/v (``local_kv``), MLA's
normed latents and its k_rope, MLA's whole ``wo`` before its rows are
sliced.
The sequence-parallel decodes ``decode_attention_sp`` and
``mla_decode_sp`` attend over this rank's slots of a cache whose sequence
dim is sharded over ``dist.kv_seq`` and combine the shards' partial
softmaxes by log-sum-exp (``_lse_combine``), with the SP functions' own
numerics.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import common as C
from repro_torch.models import layers as L
from repro_torch.models.moe import _bmm_f32   # f32 outputs, no upcast

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


def project_qkv(x, p, cfg, kv_x=None, dist=None):
    """Returns q (b,s,nq,hd), k/v (b,skv,nkv,hd): k and v from ``kv_x``
    (b, skv, d) where given (cross-attention), else from x.  The head
    counts are the weights' (this rank's q heads on a mesh, where x and
    the q norm's scale enter the split product)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    kv_x = x if kv_x is None else kv_x
    split = p["wq"].shape[-1] < cfg.n_heads * hd
    q = (C.enter_split(x, split, dist) @ p["wq"]).reshape(b, s, -1, hd)
    k = (kv_x @ p["wk"]).reshape(b, kv_x.shape[1], -1, hd)
    v = (kv_x @ p["wv"]).reshape(b, kv_x.shape[1], -1, hd)
    if "q_scale" in p:
        q = L.head_rmsnorm(q) * C.enter_split(p["q_scale"], split, dist)
        k = L.head_rmsnorm(k) * p["k_scale"]
    return q, k, v


def local_kv(k, n_heads, n_local, dist):
    """k or v (b, s, nkv, hd), which every rank computes whole, for this
    rank's ``n_local`` q heads (``repeat_kv``); entering the split heads'
    computation where ``n_local < n_heads``."""
    h0 = head_offset(n_local, n_heads, dist)
    k = C.enter_split(k, n_local < n_heads, dist)
    return repeat_kv(k, n_heads, h0, n_local)


def repeat_kv(k, n_heads, head0=0, n_local=None):
    """k (b, s, nkv, hd) -> the kv head of each of ``n_heads`` q heads
    (q head j reads kv head j // (n_heads // nkv)); with ``n_local``, of
    q heads [head0, head0 + n_local) only: a rank's local heads."""
    nkv = k.shape[2]
    if n_local is None or n_local == n_heads:
        if nkv == n_heads:
            return k
        return torch.repeat_interleave(k, n_heads // nkv, dim=2)
    heads = torch.arange(head0, head0 + n_local, device=k.device)
    return k.index_select(2, heads // (n_heads // nkv))


def head_offset(n_local, n_heads, dist):
    """This rank's first q head: 0 with every head local, else its
    `model` index times ``n_local`` (heads split over ``dist.tp``)."""
    if n_local == n_heads:
        return 0
    return dist.comm.axis_index(dist.tp) * n_local


def out_proj(o, wo, n_local, n_heads, dist):
    """o (..., n_local * hd_v) @ wo.  With every head local, the product.
    With this rank's heads only, a partial sum over ``dist.tp``, summed
    here: ``wo`` is either split by rows already (the rule table's
    ``shard_heads``) or held whole (MLA), and then its rows of the local
    heads are taken."""
    if n_local == n_heads:
        return o @ wo
    if wo.shape[0] != o.shape[-1]:
        r0 = head_offset(n_local, n_heads, dist) * (o.shape[-1] // n_local)
        wo = dist.comm.enter(wo, dist.tp)[r0:r0 + o.shape[-1]]
    return dist.comm.psum(o @ wo, dist.tp)


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


def mla_latents(x, p, cfg, positions, dist=None):
    """The cached quantities: c_kv (b, s, r_kv) and k_rope (b, s, hd_r),
    k_rope rotated as one head with ``cfg.rope_theta``."""
    m = cfg.mla
    kv = C.col_product(x, p["wkv_a"], m.kv_lora_rank + m.qk_rope_head_dim,
                       dist)
    c_kv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    c_kv = _rms(c_kv, p["kv_norm"])
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def mla_queries(x, p, cfg, positions, dist=None):
    """(q_nope (b, s, h, hd_n), q_rope (b, s, h, hd_r)) of ``wq_b``'s
    heads."""
    m = cfg.mla
    b, s, _ = x.shape
    q_a = C.col_product(x, p["wq_a"], m.q_lora_rank, dist)
    split = p["wq_b"].shape[-1] < cfg.n_heads * (m.qk_nope_head_dim
                                                 + m.qk_rope_head_dim)
    q = C.enter_split(_rms(q_a, p["q_norm"]), split, dist) @ p["wq_b"]
    q = q.reshape(b, s, -1, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = (q[..., :m.qk_nope_head_dim],
                      q[..., m.qk_nope_head_dim:])
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def mla_prefill(x, p, cfg, positions, dist=None):
    """Expanded MLA for train and prefill, causal, through K1's
    dispatcher on ``wq_b``'s heads; returns (out (b, s, d), c_kv,
    k_rope)."""
    m, nq = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    c_kv, k_rope = mla_latents(x, p, cfg, positions, dist)
    q_nope, q_rope = mla_queries(x, p, cfg, positions, dist)
    h = q_nope.shape[2]
    c_kv_h = C.enter_split(c_kv, h < nq, dist)
    k_rope_h = C.enter_split(k_rope, h < nq, dist)
    k_nope = (c_kv_h @ p["wk_b"]).reshape(b, s, h, m.qk_nope_head_dim)
    v = (c_kv_h @ p["wv_b"]).reshape(b, s, h, m.v_head_dim)
    # contiguous in the head dim, as K1 takes them: the concatenation
    # materialises the broadcast k_rope
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    # v at its own width: K1 computes the reference's padded call's first
    # v_head_dim columns
    o = flash_ops.flash_attention(q, k, v, causal=True)
    o = o.reshape(b, s, h * m.v_head_dim)
    return out_proj(o, p["wo"], h, nq, dist), c_kv, k_rope


def _absorbed_queries(x, p, cfg, positions, dist):
    """(q_abs (b, 1, h, r_kv) f32, q_rope (b, 1, h, hd_r)) of ``wq_b``'s
    heads: q_nope · W_kb, the query against the latent cache."""
    m = cfg.mla
    q_nope, q_rope = mla_queries(x, p, cfg, positions, dist)  # (b,1,h,.)
    wk_b = p["wk_b"].reshape(m.kv_lora_rank, -1, m.qk_nope_head_dim)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wk_b.float())
    return q_abs, q_rope


def _latent_out(o_lat, p, cfg, x, dist):
    """o_lat (b, 1, h, r_kv) f32 of ``wv_b``'s heads -> (b, 1, d): W_vb,
    cast to x's dtype, then ``wo``."""
    m, nq = cfg.mla, cfg.n_heads
    wv_b = p["wv_b"].reshape(m.kv_lora_rank, -1, m.v_head_dim)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, wv_b.float())
    h = o.shape[2]
    o = o.reshape(x.shape[0], 1, h * m.v_head_dim).to(x.dtype)
    return out_proj(o, p["wo"], h, nq, dist)


def mla_decode(x, p, cfg, c_kv_cache, k_rope_cache, length, positions,
               dist=None):
    """Absorbed-matmul decode: the scores of q_nope · W_kb against the
    latent cache, never re-expanding per-position K/V, in f32; the output
    cast to x's dtype before ``wo``.  x (b, 1, d); ``length`` = number of
    valid cache slots."""
    m = cfg.mla
    S = c_kv_cache.shape[1]
    q_abs, q_rope = _absorbed_queries(x, p, cfg, positions, dist)
    ckv = c_kv_cache.float()
    s = torch.einsum("bqhr,bkr->bhqk", q_abs, ckv)
    s = s + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                         k_rope_cache.float())
    s = s * (1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    mask = torch.arange(S, device=x.device) < length
    pw = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", pw, ckv)
    return _latent_out(o_lat, p, cfg, x, dist)


# ---------------------------------------------------------------------------
# sequence-parallel (flash-decoding) decode: the cache's sequence dim stays
# sharded over dist.kv_seq; each shard computes a partial softmax over its
# slots and the shards combine with the log-sum-exp trick (a pmax and two
# psums of (b, h, 1[, hd]): the bytes moved a layer drop from O(cache) to
# O(heads · head_dim)).  The masked value is finite: an all-masked shard
# gets corr = 0, not NaN.


def slot_offset(S_l, dist):
    """The first cache slot this rank holds: its flattened index over
    ``dist.kv_seq`` times its slot count."""
    return dist.comm.axis_index(dist.kv_seq) * S_l


def _lse_combine(m_l, l_l, o_l, dist):
    """The shards' partial softmaxes, each (max m_l, sum l_l, unnormalised
    output o_l with one more trailing dim), combined over ``dist.kv_seq``:
    a pmax, two psums and the 1e-30 clamp of the denominator."""
    comm, axes = dist.comm, dist.kv_seq
    m_g = comm.pmax(m_l, axes)
    corr = torch.exp(m_l - m_g)
    l_g = comm.psum(l_l * corr, axes)
    o_g = comm.psum(o_l * corr[..., None], axes)
    return o_g / torch.clamp(l_g[..., None], min=1e-30)


def decode_attention_sp(q, k_cache, v_cache, length, dist, *, window=0,
                        softcap=0.0):
    """Sequence-parallel single-step decode.  q (b, 1, nq, hd), every
    head; caches (b, S_l, nkv, hd), this rank's slots [pos0, pos0 + S_l)
    of a cache sharded over ``dist.kv_seq``.  ``length`` = number of valid
    slots (ring caches pass the clamped value).

    The reference's SP numerics, not the one-device decode's: q scaled in
    f32 and rounded to the cache dtype; each group of q heads contracted
    against its shared kv head with operands in the cache dtype and f32
    outputs (no repeated or upcast cache), the probabilities rounded to
    the cache dtype for the product with v; masked slots at the finite
    -1e30."""
    b, _, nq, hd = q.shape
    S_l, kvh = k_cache.shape[1], k_cache.shape[2]
    g = nq // kvh
    pos0 = slot_offset(S_l, dist)
    scale = 1.0 / math.sqrt(hd)
    qg = (q.float() * scale).to(k_cache.dtype)
    qg = qg.reshape(b, kvh, g, hd).reshape(b * kvh, g, hd)
    kt = k_cache.permute(0, 2, 3, 1).reshape(b * kvh, hd, S_l)
    s = _softcap(_bmm_f32(qg, kt).reshape(b, kvh, g, S_l), softcap)
    pos = pos0 + torch.arange(S_l, device=q.device)
    mask = pos < length
    if window > 0:
        mask &= pos >= length - window
    s = torch.where(mask, s, NEG_INF)
    m_l = s.amax(dim=-1)                                     # (b, kvh, g)
    p = torch.exp(s - m_l[..., None])
    l_l = p.sum(dim=-1)
    vv = v_cache.permute(0, 2, 1, 3).reshape(b * kvh, S_l, hd)
    o_l = _bmm_f32(p.to(v_cache.dtype).reshape(b * kvh, g, S_l), vv)
    o = _lse_combine(m_l, l_l, o_l.reshape(b, kvh, g, hd), dist)
    return o.reshape(b, 1, nq, hd).to(q.dtype)


def mla_decode_sp(x, p, cfg, c_kv_cache, k_rope_cache, length, positions,
                  dist):
    """Sequence-parallel absorbed-matmul MLA decode: the latent cache
    (b, S_l, r_kv) holds this rank's slots; every head's scores and
    latent readout, in f32, combine by log-sum-exp in latent space, then
    W_vb and ``wo`` on this rank's heads."""
    m, nq = cfg.mla, cfg.n_heads
    S_l = c_kv_cache.shape[1]
    q_abs, q_rope = _absorbed_queries(x, p, cfg, positions, dist)
    h = q_abs.shape[2]
    if h < nq:            # every head attends this rank's slots
        q_abs = dist.comm.all_gather(q_abs, dist.tp, dim=2)
        q_rope = dist.comm.all_gather(q_rope, dist.tp, dim=2)
    ckv = c_kv_cache.float()
    s = torch.einsum("bqhr,bkr->bhqk", q_abs, ckv)
    s = s + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                         k_rope_cache.float())
    s = s * (1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    pos = slot_offset(S_l, dist) + torch.arange(S_l, device=x.device)
    s = torch.where(pos < length, s, NEG_INF)
    m_l = s.amax(dim=-1)                                     # (b, h, 1)
    pw = torch.exp(s - m_l[..., None])
    o_l = torch.einsum("bhqk,bkr->bhqr", pw, ckv)
    o_lat = _lse_combine(m_l, pw.sum(dim=-1), o_l, dist)     # (b,h,1,r)
    h0 = head_offset(h, nq, dist)
    o_lat = o_lat.transpose(1, 2)[:, :, h0:h0 + h]           # (b,1,h_l,r)
    return _latent_out(o_lat, p, cfg, x, dist)
