"""Plain torch version of the WKV6 (RWKV-6 "Finch") recurrence: a step
loop in f32.

    S_t = diag(w_t)·S_{t-1} + k_tᵀ⊗v_t
    y_t = r_t·(S_{t-1} + diag(u)·k_tᵀ⊗v_t)

Shapes: r, k, v, w (b, s, H, K[=V]); u (H, K); state (b, H, K, V).  w is
the decay already mapped to (0, 1) = exp(-exp(·)).  The CUDA kernel's
dispatcher takes it for CPU tensors, and the kernel is held against it on
the card."""
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
