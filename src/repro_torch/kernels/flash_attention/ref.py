"""Plain torch version of flash attention: materialized (sq, skv) softmax.

The CUDA kernel's dispatcher takes it for CPU tensors, and the kernel is
held against it on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q (b, sq, h, hd); k/v (b, skv, h, hd).  f32 softmax; returns
    q.dtype.  The causal mask aligns q and k from position 0."""
    sq, hd = q.shape[1], q.shape[3]
    skv = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
