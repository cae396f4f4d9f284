"""Dispatcher for flash attention: the CUDA kernels for tensors on the
card, the plain torch version (ref.py) for tensors on the CPU, where
autograd differentiates it.

There is no fallback: a CUDA tensor launches the kernel or raises.  A
CUDA call that needs a gradient goes through ``_FlashAttention``, a
``torch.autograd.Function`` whose forward launches the forward kernel and
whose backward launches the backward kernels (``kernel_bwd``); the plain
gradient (``attention_bwd_ref``) is never taken on the card.  The
forward kernel has two variants; ``kernel.plan`` picks one before launch
from dtype, head dim and strides.  So does the backward:
``kernel_bwd.plan`` picks its route when the forward runs, since only the
forward's Hopper variant, in training mode, writes the log-sum-exp the
Hopper backward reads.  A call on the "hopper" route (bf16 at hd = dv
of 64, 128 or 256, q/k/v TMA can read: exactly the calls whose forward
writes one, ``kernel.writes_lse``) saves it with ``save_for_backward``
(so a layer recomputed under activation checkpointing recomputes it too)
and hands it to the backward; the "general" route's stats kernel
recomputes it.

v may be narrower than q and k (dv < hd: MLA's v at 128 columns beside
q·k's 192).  The function is then the TPU kernel's on v zero-padded to hd,
o its first dv columns; the forward and the backward kernels compute it
without the padding (the backward's "general" route takes every hd up to
256 and every dv <= hd, so MLA's forward keeps the Hopper variant under a
gradient too).

Counts: ``launches`` counts forward kernel launches and nothing else (a
layer recomputed under activation checkpointing launches again, and
counts again); ``launches_by_variant`` counts the same launches by the
variant each took; ``launches_bwd`` counts backward kernel launches,
three a call of either variant (``kernel_bwd.KERNELS``: preprocess, dK/dV
and dQ for "hopper"; stats, dK/dV and dQ for "general");
``launches_bwd_by_variant`` counts the same launches by variant;
``bwd_calls_by_lse`` counts backward calls by where their LSE came from
("forward": the forward's training mode; "recomputed": the general
stats kernel's third S = Q K^T); ``bwd_dout_copies`` counts the dOs the
Hopper route copied because TMA could not read them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, kernel_bwd
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0
launches_by_variant = dict.fromkeys(kernel.VARIANTS, 0)
launches_bwd = 0
launches_bwd_by_variant = dict.fromkeys(kernel_bwd.VARIANTS, 0)
bwd_calls_by_lse = {"forward": 0, "recomputed": 0}
bwd_dout_copies = 0


def _check(q, k, v, window):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or k.shape[:3] != v.shape[:3]
            or not 1 <= v.shape[3] <= k.shape[3]):
        raise ValueError(f"expected q (b,sq,h,hd), k (b,skv,h,hd), v "
                         f"(b,skv,h,dv) with 1 <= dv <= hd; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, hd):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (repeat GQA heads first)")
    sq, skv = q.shape[1], k.shape[1]
    if skv == 0 or sq == 0:
        raise ValueError("empty sequence")
    # Row sq-1 sees keys in (sq-1-window, skv); with none, its softmax
    # would average masked keys, which the kernel's tile skipping and the
    # plain version's full softmax do differently.
    if window and sq > skv + window - 1:
        raise ValueError(f"window {window} with sq {sq} > skv {skv} + "
                         f"window - 1 leaves rows with no key to attend to")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q (b, sq, h, hd), k (b, skv, h, hd), v (b, skv, h, dv) with 1 <= dv
    <= hd -> (b, sq, h, dv) in q.dtype: the TPU kernel applied to v
    zero-padded to hd; o is its first dv columns (the scale stays 1/sqrt
    of hd).  Same contract as the TPU kernel: the causal mask aligns q and
    k from position 0.  Every row must have a key to attend to: a window
    with sq > skv + window - 1 raises.  Differentiable on both devices; on
    the card up to head dim ``kernel.MAX_HEAD_DIM`` (256), the backward
    (``kernel_bwd.MAX_HEAD_DIM``, 256) taking every dv <= hd."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    if q.dtype not in kernel.DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] > kernel.MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[3]} > {kernel.MAX_HEAD_DIM}")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError(f"batch/heads too large for the grid: "
                         f"{tuple(q.shape)}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q/k/v must have stride 1")
    kw = dict(causal=bool(causal), window=int(window),
              softcap=float(softcap))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kw)
    return _forward(q, k, v, kw)


def _forward(q, k, v, kw, lse=None):
    global launches
    variant = kernel.plan(q, k, v)
    out = kernel.flash_attention_cuda(q, k, v, variant, lse=lse, **kw)
    launches += 1
    launches_by_variant[variant] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward and backward kernels of one CUDA call, on the route
    ``kernel_bwd.plan`` picks before the forward.  Saves q, k, v (as the
    views they are) and the output, and on the "hopper" route the
    forward's LSE."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.route = kernel_bwd.plan(q, k, v)
        ctx.kw = kw
        if ctx.route == "hopper":
            lse = kernel.lse_buffer(q)
            out = _forward(q, k, v, kw, lse=lse)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = _forward(q, k, v, kw)
            ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, do):
        global launches_bwd, bwd_dout_copies
        q, k, v, out, *lse = ctx.saved_tensors
        if ctx.route == "hopper" and not kernel_bwd.dout_ok(do):
            do = do.clone(memory_format=torch.contiguous_format)
            bwd_dout_copies += 1
        elif do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv = kernel_bwd.flash_attention_bwd_cuda(
            q, k, v, out, do, ctx.route, lse=lse[0] if lse else None,
            **ctx.kw)
        n = len(kernel_bwd.KERNELS[ctx.route])
        launches_bwd += n
        launches_bwd_by_variant[ctx.route] += n
        bwd_calls_by_lse["forward" if lse else "recomputed"] += 1
        return dq, dk, dv, None
