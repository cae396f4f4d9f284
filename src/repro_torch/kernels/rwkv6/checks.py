"""Inputs and limits for holding the WKV6 kernel against its plain
version, shared by ``chip_smoke.py`` and the card-only tests.

Limits, as for flash attention: elementwise |out - ref| <= tol x (rms of
ref + |ref|), and ||out - ref|| / ||ref|| of every row.  y (rows (b, t,
h)): f32 2e-5 and 1e-5 -- both sides sum in f32, in other orders; bf16
1e-2 -- both sides round the same f32 sums to bf16, and where they round
apart they differ by one ulp (2^-8 to 2^-7 relative), about 2e-3 of a
row's norm at worst.  The final state (rows (b, h, i), f32 on both sides,
the same products; the kernel fuses w S + k v into one FMA): 1e-4
elementwise and 1e-5 by row.

The backward's gradients (``kernel_bwd``) are held row by row to their
scale, as flash attention's are (``bwd_row_scales``): the norm of the sum
of the magnitudes of the terms that make a row, which is the plain
backward run on |inputs| (every term then adds).  With w near 1 a state
or G entry sums ~400 rank-1 terms of either sign, so a row's own norm can
be far below the rounding its terms carry.  Limits (``BWD_ROW_TOL``):
2e-5 for every f32 gradient -- both sides sum the same f32 terms in other
orders and the kernel fuses w S + k v into one FMA, a rounding of 2^-24
of the scale a step that adds up like a random walk over up to s = 2048
steps (~3e-6); in bf16, 1e-2 for dr, dk, dv, which both sides round to
bf16 (2^-9 of the element at most), and 2e-5 for dw, du and dS_0, which
stay f32 from the same bf16 inputs.  ``wkv6_bwd_faulty`` gives the
gradients with one fault a kernel could make (``BWD_FAULTS``), each of
which must land past the limits.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
STATE_TOL, STATE_ROW_TOL = 1e-4, 1e-5
GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")
BWD_ROW_TOL = {torch.float32: dict.fromkeys(GRADS, 2e-5),
               torch.bfloat16: {**dict.fromkeys(GRADS, 2e-5),
                                "dr": 1e-2, "dk": 1e-2, "dv": 1e-2}}
# * "no-g-decay": G_{t-1} = G_t + r_t^T dy_t, the decay dropped;
# * "dw-late": dw_t = rowsum(G_t * S_t), the state one step late;
# * "du-one-row": du summed over batch row 0 only;
# * "no-u-in-dk": dk_t = G_t v_t, the u term dropped.
BWD_FAULTS = ("no-g-decay", "dw-late", "du-one-row", "no-u-in-dk")


def inputs(shape, dtype, gen, strided=False, state_scale=0.0):
    """(r, k, v, w, u, state) as the model makes them, on ``gen``'s
    device: r, k, v ~ N(0, 1) in ``dtype``; the decay w = exp(-exp(-6 +
    N(0, 1))) in f32, close to 1, so the state carries across the whole
    sequence (|y| grows to ~100 at s = 1024); u ~ N(0, 0.01) in
    ``dtype``; the state N(0, state_scale^2) in f32.  ``strided``: r/k/v
    are (b, s, H, hd) views of one (b, s, 3d) tensor and w of a (b, s,
    2d) one, as slices of a fused projection would be."""
    b, s, h, hd = shape
    d = h * hd

    def randn(*size):
        return torch.randn(size, generator=gen, device=gen.device)

    if strided:
        rkv = randn(b, s, 3 * d).to(dtype)
        r, k, v = (rkv[..., i * d:(i + 1) * d].view(b, s, h, hd)
                   for i in range(3))
        w = torch.exp(-torch.exp(-6 + randn(b, s, 2 * d)))[..., :d]
        w = w.view(b, s, h, hd)
    else:
        r, k, v = (randn(b, s, h, hd).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(-6 + randn(b, s, h, hd)))
    u = (randn(h, hd) * 0.1).to(dtype)
    state = randn(b, h, hd, hd) * state_scale
    return r, k, v, w, u, state


def bwd_inputs(shape, dtype, gen, strided=False, state_scale=0.0,
               dstate_scale=0.0, fast_decay=False):
    """(r, k, v, w, u, state, dy, dstate) for the backward: ``inputs``'
    forward inputs, dy ~ N(0, 1) in ``dtype`` (with ``strided`` a (b, s,
    H, hd) view of a (b, s, 2d) tensor, as the slice of a fused
    projection's gradient would be) and dstate N(0, dstate_scale^2) in f32
    (None at 0).  ``fast_decay``: w = exp(-exp(1 + 2 N(0, 1))), from
    about 1 down to 0 in f32 (exactly 0 past N > 1.75, about 4% of
    entries), where the states forget within a few steps."""
    b, s, h, hd = shape
    r, k, v, w, u, state = inputs(shape, dtype, gen, strided, state_scale)
    if fast_decay:
        w = torch.exp(-torch.exp(
            1 + 2 * torch.randn(shape, generator=gen, device=gen.device)))
    if strided:
        dy = torch.randn((b, s, 2 * h * hd), generator=gen,
                         device=gen.device).to(dtype)[..., :h * hd]
        dy = dy.view(b, s, h, hd)
    else:
        dy = torch.randn(shape, generator=gen, device=gen.device).to(dtype)
    dstate = (torch.randn((b, h, hd, hd), generator=gen, device=gen.device)
              * dstate_scale if dstate_scale else None)
    return r, k, v, w, u, state, dy, dstate


def bwd_row_scales(r, k, v, w, u, state, dy, dstate=None):
    """Per-row scale of each gradient of ``wkv6_bwd_ref``, in ``GRADS``'
    order: the plain backward on the magnitudes of its inputs (w is in
    [0, 1] already), each gradient's norm over its last dim.  Rows: (b,
    s, H) of dr, dk, dv, dw; H of du; (b, H, K) of dS_0."""
    mags = wkv6_bwd_ref(r.abs(), k.abs(), v.abs(), w, u.abs(), state.abs(),
                        dy.abs(), None if dstate is None else dstate.abs())
    return tuple(m.norm(dim=-1) for m in mags)


def grad_row_err(out, ref, row_scale):
    """Worst ||out - ref|| / row scale over the rows of one gradient."""
    err = (out.float() - ref.float()).norm(dim=-1)
    return (err / row_scale.clamp_min(1e-30)).max().item()


def bwd_errors(grads, ref, scales):
    """{name: worst row error} of each gradient of ``GRADS``."""
    return {name: grad_row_err(g, r, m)
            for name, g, r, m in zip(GRADS, grads, ref, scales)}


def bwd_within(errors, dtype):
    """Whether every gradient's worst row is finite and within its limit."""
    return all(math.isfinite(e) and e <= BWD_ROW_TOL[dtype][name]
               for name, e in errors.items())


def wkv6_bwd_faulty(r, k, v, w, u, state, dy, dstate, fault):
    """``wkv6_bwd_ref``'s gradients with ``fault`` (``BWD_FAULTS``), in
    f32."""
    if fault not in BWD_FAULTS:
        raise ValueError(f"no fault {fault!r}; one of {BWD_FAULTS}")
    dr, dk, dv, dw, du, ds0 = wkv6_bwd_ref(r, k, v, w, u, state, dy, dstate)
    rf, kf, vf, wf, dyf = (t.float() for t in (r, k, v, w, dy))
    uf = u.float()
    vd = (vf * dyf).sum(-1)
    if fault == "du-one-row":
        return dr, dk, dv, dw, (rf * kf * vd[..., None])[:1].sum((0, 1)), ds0
    if fault == "no-u-in-dk":
        return dr, dk - uf * rf * vd[..., None], dv, dw, du, ds0
    # the faults of the reverse pass: run it again with the fault
    S = state.float()
    after = []
    for t in range(r.shape[1]):
        S = wf[:, t, ..., None] * S + kf[:, t, ..., None] * vf[:, t, :, None, :]
        after.append(S)
    G = torch.zeros_like(S) if dstate is None else dstate.float()
    a = (uf * rf * kf).sum(-1)
    for t in reversed(range(r.shape[1])):
        dk[:, t] = (torch.einsum("bhkv,bhv->bhk", G, vf[:, t])
                    + uf * rf[:, t] * vd[:, t, :, None])
        dv[:, t] = (torch.einsum("bhkv,bhk->bhv", G, kf[:, t])
                    + a[:, t, :, None] * dyf[:, t])
        if fault == "dw-late":
            dw[:, t] = (G * after[t]).sum(-1)
        decay = 1.0 if fault == "no-g-decay" else wf[:, t, ..., None]
        G = decay * G + rf[:, t, ..., None] * dyf[:, t, :, None, :]
    return dr, dk, dv, dw, du, G
