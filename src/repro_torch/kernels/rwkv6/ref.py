"""Plain torch version of the WKV6 (RWKV-6 "Finch") recurrence: a step
loop in f32.

    S_t = diag(w_t)·S_{t-1} + k_tᵀ⊗v_t
    y_t = r_t·(S_{t-1} + diag(u)·k_tᵀ⊗v_t)

Shapes: r, k, v, w (b, s, H, K[=V]); u (H, K); state (b, H, K, V).  w is
the decay already mapped to (0, 1) = exp(-exp(·)).  The CUDA kernel's
dispatcher takes it for CPU tensors, and the kernel is held against it on
the card.

``wkv6_checkpoints`` is the plain version of what K2's forward stores in
training mode: the state S_{t-1} at every t that is a multiple of
``steps``.  ``wkv6_bwd_ref`` is the explicit gradient, the backward
kernel's plain version: with G_t = dL/dS_t (G_T the final state's gradient),

    G_{t-1} = diag(w_t)·G_t + r_tᵀ⊗dy_t
    dr_t = S_{t-1}·dy_t + u ⊙ k_t (v_t·dy_t)
    dk_t = G_t·v_t + u ⊙ r_t (v_t·dy_t)
    dv_t = G_tᵀ·k_t + (Σ u ⊙ r_t ⊙ k_t) dy_t
    dw_t = rowsum(G_t ⊙ S_{t-1})
    du = Σ_{b, t} r_t ⊙ k_t (v_t·dy_t),  dS_0 = G_0."""
from __future__ import annotations

import torch


def step(rt, kt, vt, wt, uf, S):
    """One step on f32 tensors: rt/kt/vt/wt (b, H, K), uf (H, K), S (b,
    H, K, V).  Returns (y (b, H, V), new S)."""
    outer = kt[..., :, None] * vt[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rt, S + uf[None, :, :, None] * outer)
    return y, wt[..., :, None] * S + outer


def wkv6_ref(r, k, v, w, u, state):
    """Returns (y (b, s, H, V) in r.dtype, final state f32)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        y, S = step(rf[:, t], kf[:, t], vf[:, t], wf[:, t], uf, S)
        ys.append(y)
    return torch.stack(ys, dim=1).to(r.dtype), S


def wkv6_checkpoints(k, v, w, state, steps):
    """The states before steps 0, ``steps``, 2 ``steps``, .. of
    ``wkv6_ref`` (S_0 first): (b, H, ceil(s / steps), K, V) f32."""
    kf, vf, wf = (t.float() for t in (k, v, w))
    S = state.float()
    out = []
    for t in range(k.shape[1]):
        if t % steps == 0:
            out.append(S)
        S = wf[:, t, ..., None] * S + kf[:, t, ..., None] * vf[:, t, :, None, :]
    return torch.stack(out, dim=2)


def wkv6_bwd_ref(r, k, v, w, u, state, dy, dstate=None):
    """The gradients of ``wkv6_ref``'s (y, final state) given dy (b, s, H,
    V) and ``dstate`` (b, H, K, V; None is zeros): (dr, dk, dv, dw, du,
    dstate_0), every one in f32, step by step.  Keeps every S_{t-1} (b
    x s x H x K x V floats)."""
    rf, kf, vf, wf, dyf = (t.float() for t in (r, k, v, w, dy))
    uf = u.float()
    S = state.float()
    prev = []
    for t in range(r.shape[1]):
        prev.append(S)
        S = wf[:, t, ..., None] * S + kf[:, t, ..., None] * vf[:, t, :, None, :]
    vd = (vf * dyf).sum(-1)                                  # (b, s, H)
    prev = torch.stack(prev, dim=1)                          # (b, s, H, K, V)
    dr = (torch.einsum("bshkv,bshv->bshk", prev, dyf)
          + uf * kf * vd[..., None])
    G = (torch.zeros_like(S) if dstate is None else dstate.float())
    dk, dv, dw = (torch.empty_like(rf) for _ in range(3))
    a = (uf * rf * kf).sum(-1)                               # (b, s, H)
    for t in reversed(range(r.shape[1])):
        dk[:, t] = (torch.einsum("bhkv,bhv->bhk", G, vf[:, t])
                    + uf * rf[:, t] * vd[:, t, :, None])
        dv[:, t] = (torch.einsum("bhkv,bhk->bhv", G, kf[:, t])
                    + a[:, t, :, None] * dyf[:, t])
        dw[:, t] = (G * prev[:, t]).sum(-1)
        G = wf[:, t, ..., None] * G + rf[:, t, ..., None] * dyf[:, t, :, None, :]
    du = (rf * kf * vd[..., None]).sum((0, 1))
    return dr, dk, dv, dw, du, G
