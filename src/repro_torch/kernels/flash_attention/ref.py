"""Plain torch version of flash attention and of its gradient:
materialized (sq, skv) softmax.

The CUDA kernels' dispatcher takes them for CPU tensors, and the kernels
are held against them on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def scores(q, k, *, causal=True, window=0, softcap=0.0):
    """(s, t): the f32 scores (b, h, sq, skv) after the scale, the softcap
    and the -1e30 mask, and tanh(raw / softcap) (None without a softcap).
    The causal mask aligns q and k from position 0."""
    sq, hd = q.shape[1], q.shape[3]
    skv = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    return torch.where(mask, s, NEG_INF), t


def attention_lse(q, k, *, causal=True, window=0, softcap=0.0):
    """Each row's log-sum-exp of its scaled, capped, masked scores: (b, h,
    sq) f32, natural log units.  What the forward's training mode writes
    for the backward's Hopper variant."""
    s, _ = scores(q, k, causal=causal, window=window, softcap=softcap)
    return torch.logsumexp(s, dim=-1)


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q (b, sq, h, hd), k (b, skv, h, hd), v (b, skv, h, dv) with dv <= hd
    -> (b, sq, h, dv): the function on v zero-padded to hd, o's first dv
    columns (the scale is 1/sqrt(hd)).  f32 softmax; returns q.dtype.  The
    causal mask aligns q and k from position 0."""
    s, _ = scores(q, k, causal=causal, window=window, softcap=softcap)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def attention_bwd_ref(q, k, v, o, do, *, causal=True, window=0,
                      softcap=0.0):
    """The gradient of ``attention_ref`` by its explicit formula, in f32:
    P = softmax(S), dV = P^T dO, dP = dO V^T, D = rowsum(dO * O), dS =
    P (dP - D), times 1 - tanh^2(s / c) under a softcap, dQ = dS K *
    scale, dK = dS^T Q * scale.  ``o`` is the forward's output and ``do``
    the gradient at it.  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    scale = 1.0 / math.sqrt(q.shape[3])
    s, t = scores(q, k, causal=causal, window=window, softcap=softcap)
    p = torch.softmax(s, dim=-1)
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    d = (dof * o.float()).sum(dim=-1).transpose(1, 2)[..., None]  # b h q 1
    ds = p * (dp - d)
    if t is not None:
        ds = ds * (1 - t * t)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
