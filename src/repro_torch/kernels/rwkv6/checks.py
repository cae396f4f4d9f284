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
"""
from __future__ import annotations

import torch

TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
STATE_TOL, STATE_ROW_TOL = 1e-4, 1e-5


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
