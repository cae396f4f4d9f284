"""Dispatcher for the Mamba selective scan: the CUDA kernel for tensors
on the card, the plain torch version (ref.py) for tensors on the CPU,
where autograd differentiates it.

There is no fallback: a CUDA tensor launches the kernel or raises.  A
CUDA call that needs a gradient goes through ``_SelectiveScan``, a
``torch.autograd.Function`` whose forward launches the forward kernel in
training mode (it also stores the state every ``kernel.CK_STEPS`` steps)
and saves those checkpoints beside its inputs, and whose backward
launches the backward's kernels (``kernel_bwd``) on them; the plain
gradient (``selective_scan_bwd_ref``) is never taken on the card.  A
layer recomputed under activation checkpointing saves them again: the
recompute's checkpoints are the ones the backward reads.

Counts: ``launches`` counts forward kernel launches and nothing else (a
recomputed layer launches again, and counts again), ``launches_by_mode``
the same launches by mode ("serving", "training"); ``launches_bwd``
counts backward kernel launches, ``len(kernel_bwd.KERNELS)`` a call.

``selective_scan_step`` (one token, the decode path) is plain torch ops on
every device, as the reference's is jnp.  The reference's
``selective_scan_chunked`` is its differentiable twin: the port
differentiates ``ref.py`` on the CPU and runs the backward kernel on the
card instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import kernel, kernel_bwd
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref, step

launches = 0
launches_by_mode = {"serving": 0, "training": 0}
launches_bwd = 0


def _check(x, dt, A, B, C, D, state):
    tensors = (x, dt, A, B, C, D, state)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"x/dt/A/B/C/D/state on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_floating_point() for t in tensors):
        raise TypeError(f"selective_scan takes floating-point tensors; got "
                        f"{[str(t.dtype) for t in tensors]}")
    if x.dim() != 3 or dt.shape != x.shape or A.dim() != 2:
        raise ValueError(f"expected x, dt (b,s,di) and A (di,N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}")
    b, s, di = x.shape
    n = A.shape[1]
    if (A.shape[0] != di or tuple(B.shape) != (b, s, n)
            or tuple(C.shape) != (b, s, n) or tuple(D.shape) != (di,)
            or tuple(state.shape) != (b, di, n)):
        raise ValueError(
            f"expected A {(di, n)}, B and C {(b, s, n)}, D {(di,)} and "
            f"state {(b, di, n)}; got {tuple(A.shape)}, {tuple(B.shape)}, "
            f"{tuple(C.shape)}, {tuple(D.shape)}, {tuple(state.shape)}")
    if s == 0:
        raise ValueError("empty sequence")


def selective_scan(x, dt, A, B, C, D, state):
    """x, dt (b, s, di); A (di, N); B, C (b, s, N); D (di,); state (b, di,
    N).  Returns (y (b, s, di) in x.dtype, final state f32).
    Differentiable on both devices."""
    _check(x, dt, A, B, C, D, state)
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, A, B, C, D, state)
    if x.device.type != "cuda":
        raise ValueError(f"no selective_scan for device {x.device}")
    if x.dtype not in kernel.DTYPES or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 x/B/C of one "
                        f"dtype; got {x.dtype}, {B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, D, state)):
        raise TypeError(f"kernel takes float32 dt, A, D and state; got "
                        f"{dt.dtype}, {A.dtype}, {D.dtype}, {state.dtype}")
    if A.shape[1] > kernel.MAX_STATE:
        raise ValueError(f"state size {A.shape[1]} > {kernel.MAX_STATE}")
    if x.shape[0] > 65535:
        raise ValueError(f"batch too large for the grid: {tuple(x.shape)}")
    if any(t.stride(2) != 1 for t in (x, dt, B, C)):
        raise ValueError("the last dim of x/dt/B/C must have stride 1")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C, D, state)):
        return _SelectiveScan.apply(x, dt, A, B, C, D, state)
    return _forward(x, dt, A, B, C, D, state)


def _forward(x, dt, A, B, C, D, state, checkpoints=None):
    """The forward kernel; with ``checkpoints`` in training mode, storing
    the state every ``kernel.CK_STEPS`` steps there."""
    global launches
    out = kernel.selective_scan_cuda(x, dt, A.contiguous(), B, C,
                                     D.contiguous(), state.contiguous(),
                                     checkpoints=checkpoints)
    launches += 1
    launches_by_mode["serving" if checkpoints is None else "training"] += 1
    return out


class _SelectiveScan(torch.autograd.Function):
    """The forward kernel in training mode and the backward's kernels of
    one CUDA call.  Saves x, dt, A, B, C, D and the initial state, B and C
    as the views they are, and the forward's checkpoints.  A gradient it
    is not given (the final state's, where the caller drops it) is
    zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, state):
        ctx.set_materialize_grads(False)
        ck = torch.empty(kernel_bwd.checkpoint_shape((*x.shape, A.shape[1])),
                         dtype=torch.float32, device=x.device)
        y, h = _forward(x, dt, A, B, C, D, state, ck)
        ctx.save_for_backward(x, dt, A, B, C, D, state, ck)
        return y, h

    @staticmethod
    def backward(ctx, dy, dstate):
        global launches_bwd
        x, dt, A, B, C, D, state, ck = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        elif dy.dtype != x.dtype or dy.stride(2) != 1:
            dy = dy.to(x.dtype).contiguous()
        grads = kernel_bwd.selective_scan_bwd_cuda(
            x, dt, A.contiguous(), B, C, D.contiguous(), state.contiguous(),
            dy, None if dstate is None else dstate.float().contiguous(),
            checkpoints=ck)
        launches_bwd += len(kernel_bwd.KERNELS)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan_step(x1, dt1, A, B1, C1, D, state):
    """Single-token decode step: x1, dt1 (b, di); B1, C1 (b, N); state
    (b, di, N).  Returns (y (b, di) in x1.dtype, new state f32)."""
    y, h = step(x1.float(), dt1.float(), A.float(), B1.float(), C1.float(),
                D.float(), state.float())
    return y.to(x1.dtype), h
