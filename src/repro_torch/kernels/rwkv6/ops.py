"""Dispatcher for the WKV6 recurrence: the CUDA kernel for tensors on the
card, the plain torch version (ref.py) for tensors on the CPU.

There is no fallback: a CUDA tensor launches the kernel or raises.  There
is no backward kernel yet, so a CUDA call that would need a gradient
raises too.  ``launches`` counts kernel launches and nothing else;
``launches_by_plan`` counts them by the (G, C, CB) that ``kernel.plan``
chose.

``wkv6_step`` (one token, the decode path) is plain torch ops on every
device, as the reference's is jnp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import kernel
from repro_torch.kernels.rwkv6.ref import step, wkv6_ref

launches = 0
launches_by_plan: dict = {}


def _check(r, k, v, w, u, state):
    tensors = (r, k, v, w, u, state)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"r/k/v/w/u/state on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"expected r/k/v/w of one shape (b,s,H,hd); got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    if not all(t.is_floating_point() for t in tensors):
        raise TypeError(f"wkv6 takes floating-point tensors; got "
                        f"{[str(t.dtype) for t in tensors]}")
    b, s, h, hd = r.shape
    if tuple(u.shape) != (h, hd) or tuple(state.shape) != (b, h, hd, hd):
        raise ValueError(f"expected u {(h, hd)} and state {(b, h, hd, hd)}; "
                         f"got {tuple(u.shape)}, {tuple(state.shape)}")
    if s == 0:
        raise ValueError("empty sequence")


def wkv6(r, k, v, w, u, state):
    """r/k/v/w (b, s, H, hd); u (H, hd); state (b, H, hd, hd).  Returns
    (y (b, s, H, hd) in r.dtype, final state f32)."""
    global launches
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 for device {r.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        raise NotImplementedError("wkv6 has no backward kernel yet; call it "
                                  "under torch.no_grad()")
    if r.dtype not in kernel.DTYPES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 r/k/v of one "
                        f"dtype; got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 w and state; got {w.dtype}, "
                        f"{state.dtype}")
    if u.dtype not in kernel.DTYPES:      # bf16 u converts to f32 exactly
        raise TypeError(f"kernel takes u in float32 or bfloat16; got "
                        f"{u.dtype}")
    if r.shape[3] > kernel.MAX_HEAD_DIM:
        raise ValueError(f"head dim {r.shape[3]} > {kernel.MAX_HEAD_DIM}")
    if r.shape[0] > 65535:
        raise ValueError(f"batch too large for the grid: {tuple(r.shape)}")
    if any(t.stride(3) != 1 for t in (r, k, v, w)):
        raise ValueError("the head dim of r/k/v/w must have stride 1")
    plan = kernel.plan(r.shape, r.dtype)
    out = kernel.wkv6_cuda(r, k, v, w, u.float().contiguous(),
                           state.contiguous(), plan)
    launches += 1
    launches_by_plan[plan] = launches_by_plan.get(plan, 0) + 1
    return out


def wkv6_step(r1, k1, v1, w1, u, state):
    """Single-token decode step: r1/k1/v1/w1 (b, H, hd); state (b, H, hd,
    hd).  Returns (y (b, H, hd) in r1.dtype, new state f32)."""
    y, S = step(r1.float(), k1.float(), v1.float(), w1.float(), u.float(),
                state.float())
    return y.to(r1.dtype), S
