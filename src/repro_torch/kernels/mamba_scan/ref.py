"""Plain torch version of the Mamba selective scan (S6): a step loop in
f32.

    h_t = exp(Δ_t·A) ⊙ h_{t-1} + (Δ_t·x_t)·B_t
    y_t = h_t·C_t + D ⊙ x_t

Shapes: x, dt (b, s, di); A (di, N); B, C (b, s, N); D (di,); state h
(b, di, N).  ``dt`` is already softplus'd.  The CUDA kernel's dispatcher
takes it for CPU tensors, and the kernel is held against it on the
card.

``selective_scan_bwd_ref`` is the explicit gradient, the backward
kernel's plain version.  With g_t = dL/dh_t (from y_t and from h_{t+1};
g after the last step is the final state's gradient) and e_t =
exp(Δ_t·A):

    g_t = e_{t+1} ⊙ g_{t+1} + dy_t·C_t
    dC_t = Σ_c dy_t h_t,   dB_t = Σ_c g_t Δ_t x_t
    dx_t = Δ_t (g_t·B_t) + D ⊙ dy_t
    dΔ_t = Σ_n g_t ⊙ A ⊙ e_t ⊙ h_{t-1} + x_t (g_t·B_t)
    dA = Σ_{b,t} Δ_t g_t ⊙ e_t ⊙ h_{t-1},   dD = Σ_{b,t} dy_t x_t
    dh_0 = e_1 ⊙ g_1 (steps counted from 1, h_0 the initial state)

It keeps every state from the forward and walks them back; it never
divides by e_t to step a state back (e_t underflows to 0 for Δ|A|
large)."""
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


def selective_scan_bwd_ref(x, dt, A, B, C, D, state, dy, dstate=None,
                           compute=torch.float32):
    """The gradients of ``selective_scan_ref``'s (y, final state) given dy
    (b, s, di) and ``dstate`` (b, di, N; None is zeros): (dx, ddt, dA, dB,
    dC, dD, dstate_0), in the inputs' order, every one in ``compute``
    (f32; f64 for an exact yardstick), step by step.  Keeps every state
    (b x (s + 1) x di x N values)."""
    xf, dtf, Af, Bf, Cf, Df, dyf = (t.to(compute)
                                    for t in (x, dt, A, B, C, D, dy))
    h = state.to(compute)
    hs = [h]
    for t in range(x.shape[1]):
        h = (torch.exp(dtf[:, t, :, None] * Af) * h
             + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])
        hs.append(h)
    G = torch.zeros_like(h) if dstate is None else dstate.to(compute)
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    for t in reversed(range(x.shape[1])):
        e = torch.exp(dtf[:, t, :, None] * Af)
        g = G + dyf[:, t, :, None] * Cf[:, t, None, :]
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dyf[:, t])
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dtf[:, t] * xf[:, t])
        gB = torch.einsum("bdn,bn->bd", g, Bf[:, t])
        q = g * e * hs[t]
        dx[:, t] = dtf[:, t] * gB + Df * dyf[:, t]
        ddt[:, t] = (q * Af).sum(-1) + xf[:, t] * gB
        dA += torch.einsum("bdn,bd->dn", q, dtf[:, t])
        G = e * g
    dD = (dyf * xf).sum((0, 1))
    return dx, ddt, dA, dB, dC, dD, G


def selective_scan_checkpoints(x, dt, A, B, state, steps,
                               compute=torch.float32):
    """The states before steps 0, ``steps``, 2 ``steps``, .. of
    ``selective_scan_ref`` (the initial state first): (b, ceil(s / steps),
    di, N) in ``compute`` (f32; f64 for an exact yardstick), the
    training-mode forward's checkpoints."""
    xf, dtf, Af, Bf = (t.to(compute) for t in (x, dt, A, B))
    h = state.to(compute)
    out = []
    for t in range(x.shape[1]):
        if t % steps == 0:
            out.append(h)
        h = (torch.exp(dtf[:, t, :, None] * Af) * h
             + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])
    return torch.stack(out, dim=1)
