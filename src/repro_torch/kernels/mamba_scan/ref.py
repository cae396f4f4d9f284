"""Plain torch version of the Mamba selective scan (S6): a step loop in
f32.

    h_t = exp(Δ_t·A) ⊙ h_{t-1} + (Δ_t·x_t)·B_t
    y_t = h_t·C_t + D ⊙ x_t

Shapes: x, dt (b, s, di); A (di, N); B, C (b, s, N); D (di,); state h
(b, di, N).  ``dt`` is already softplus'd.  The CUDA kernel's dispatcher
takes it for CPU tensors, and the kernel is held against it on the
card."""
from __future__ import annotations

import torch


def step(xt, dtt, Af, Bt, Ct, Df, h):
    """One step on f32 tensors: xt, dtt (b, di); Af (di, N); Bt, Ct (b,
    N); Df (di,); h (b, di, N).  Returns (y (b, di), new h)."""
    dA = torch.exp(dtt[..., None] * Af[None])
    dBx = (dtt * xt)[..., None] * Bt[:, None, :]
    h = dA * h + dBx
    y = torch.einsum("bdn,bn->bd", h, Ct) + Df * xt
    return y, h


def selective_scan_ref(x, dt, A, B, C, D, state):
    """Returns (y (b, s, di) in x.dtype, final state (b, di, N) f32)."""
    xf, dtf, Af, Bf, Cf, Df = (t.float() for t in (x, dt, A, B, C, D))
    h = state.float()
    ys = []
    for t in range(x.shape[1]):
        y, h = step(xf[:, t], dtf[:, t], Af, Bf[:, t], Cf[:, t], Df, h)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), h
