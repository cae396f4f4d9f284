"""Dispatcher for flash attention: the CUDA kernel for tensors on the
card, the plain torch version (ref.py) for tensors on the CPU.

There is no fallback: a CUDA tensor launches the kernel or raises.  There
is no backward kernel yet, so a CUDA call that would need a gradient
raises too.  ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0


def _check(q, k, v, window):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q (b,sq,h,hd), k/v (b,skv,h,hd); got "
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
    """q (b, sq, h, hd); k/v (b, skv, h, hd) -> (b, sq, h, hd) in q.dtype.
    Same contract as the TPU kernel: the causal mask aligns q and k from
    position 0.  Every row must have a key to attend to: a window with
    sq > skv + window - 1 raises."""
    global launches
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError("flash attention has no backward kernel "
                                  "yet; call it under torch.no_grad()")
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
    out = kernel.flash_attention_cuda(q, k, v, causal=causal,
                                      window=int(window),
                                      softcap=float(softcap))
    launches += 1
    return out
