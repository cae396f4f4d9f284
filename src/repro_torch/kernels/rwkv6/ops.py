"""Dispatcher for the WKV6 recurrence: the CUDA kernel for tensors on the
card, the plain torch version (ref.py) for tensors on the CPU, where
autograd differentiates it.

There is no fallback: a CUDA tensor launches the kernel or raises.  A
CUDA call that needs a gradient goes through ``_WKV6``, a
``torch.autograd.Function`` whose forward launches the forward kernel
and whose backward launches the backward's kernels (``kernel_bwd``: its
own kernel, then the forward kernel run backward in time); the plain
gradient (``wkv6_bwd_ref``) is never taken on the card.
``kernel_bwd.plan`` picks the backward's route before the forward: on
"hopper" the forward runs in training mode and the Function saves its
checkpoints beside its inputs; on "general" it saves the inputs alone
(that kernel recomputes the states from S_0).  A layer recomputed under
activation checkpointing saves them again: the recompute's checkpoints
are the ones the backward reads.

Counts: ``launches`` counts forward kernel launches and nothing else (a
layer recomputed under activation checkpointing launches again, and
counts again); ``launches_by_plan`` counts them by the (G, C, CB) that
``kernel.plan`` chose; ``launches_bwd`` counts backward kernel launches,
``len(kernel_bwd.KERNELS)`` a call, and ``launches_bwd_by_route`` the
same launches by route.

``wkv6_step`` (one token, the decode path) is plain torch ops on every
device, as the reference's is jnp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import kernel, kernel_bwd
from repro_torch.kernels.rwkv6.ref import step, wkv6_ref

launches = 0
launches_by_plan: dict = {}
launches_bwd = 0
launches_bwd_by_route = dict.fromkeys(kernel_bwd.ROUTES, 0)


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
    (y (b, s, H, hd) in r.dtype, final state f32).  Differentiable on
    both devices."""
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 for device {r.device}")
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
    uf = u.float()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, uf, state)):
        # u's f32 copy is the Function's input: autograd carries du back
        # through the cast
        return _WKV6.apply(r, k, v, w, uf, state)
    return _forward(r, k, v, w, uf, state)


def _forward(r, k, v, w, uf, state, checkpoints=None):
    """The forward kernel under ``kernel.plan``; with ``checkpoints`` in
    training mode, storing the state every ``kernel_bwd.PLAN[2]`` steps
    there."""
    global launches
    plan = kernel.plan(r.shape, r.dtype)
    kw = {} if checkpoints is None else dict(
        checkpoints=checkpoints, ck_steps=kernel_bwd.PLAN[2])
    out = kernel.wkv6_cuda(r, k, v, w, uf.contiguous(), state.contiguous(),
                           plan, **kw)
    launches += 1
    launches_by_plan[plan] = launches_by_plan.get(plan, 0) + 1
    return out


class _WKV6(torch.autograd.Function):
    """Forward and backward kernels of one CUDA call, on the route
    ``kernel_bwd.plan`` picks before the forward.  Saves r, k, v, w (as
    the views they are), u in f32 and the initial state, and on the
    "hopper" route the forward's checkpoints.  A gradient it is not given
    (the final state's, where the caller drops it) is zeros."""

    @staticmethod
    def forward(ctx, r, k, v, w, uf, state):
        ctx.set_materialize_grads(False)
        ctx.route = kernel_bwd.plan(r, k, v, w)
        ck = None
        if ctx.route == "hopper":
            ck = torch.empty(
                kernel_bwd.checkpoint_shape(r.shape, kernel_bwd.PLAN[2]),
                dtype=torch.float32, device=r.device)
        y, s_out = _forward(r, k, v, w, uf, state, ck)
        ctx.save_for_backward(r, k, v, w, uf, state,
                              *(() if ck is None else (ck,)))
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        global launches_bwd
        r, k, v, w, uf, state, *ck = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        elif dy.dtype != r.dtype or dy.stride(3) != 1:
            dy = dy.to(r.dtype).contiguous()
        grads = kernel_bwd.wkv6_bwd_cuda(
            r, k, v, w, uf.contiguous(), state.contiguous(), dy,
            None if dstate is None else dstate.float().contiguous(),
            route=ctx.route, checkpoints=ck[0] if ck else None)
        launches_bwd += len(kernel_bwd.KERNELS)
        launches_bwd_by_route[ctx.route] += len(kernel_bwd.KERNELS)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def wkv6_step(r1, k1, v1, w1, u, state):
    """Single-token decode step: r1/k1/v1/w1 (b, H, hd); state (b, H, hd,
    hd).  Returns (y (b, H, hd) in r1.dtype, new state f32)."""
    y, S = step(r1.float(), k1.float(), v1.float(), w1.float(), u.float(),
                state.float())
    return y.to(r1.dtype), S
