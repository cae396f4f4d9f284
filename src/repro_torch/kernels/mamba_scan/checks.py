"""Inputs and limits for holding the selective scan kernel against its
plain version, shared by ``chip_smoke.py`` and the card-only tests.

Limits, as for WKV6: elementwise |out - ref| <= tol x (rms of ref +
|ref|), and ||out - ref|| / ||ref|| of every row.  y (rows (b, t), over
the channels): f32 2e-5 and 1e-5 -- both sides sum the same f32 terms in
other orders, and the kernel's exponential (ex2 of dt x A log2 e) is
within 2 ulp of ``torch.exp``; bf16 1e-2 -- both sides round the same
f32 values to bf16, and where they round apart they differ by one ulp
(2^-8 relative), about 5e-4 of a row's norm (a CPU estimate: the plain
version against an f64 scan rounded to bf16, (2, 1024, 512, 16)).  The
final state (rows (b, channel), f32 on both sides): 1e-4 elementwise and
1e-5 by row.

A kernel that dropped one step's update shows in y, not in the final
state: with dt ~ softplus(N(0, 1) - 4) ~ 0.02 and A in [-16, -1] the
state forgets a step within a few hundred steps.  The same CPU estimate
gave a worst y row of 0.17 (f32) and 0.24 (bf16) for the update at
t = s/2 dropped, and 1.8e-6 in the final state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
STATE_TOL, STATE_ROW_TOL = 1e-4, 1e-5


def inputs(shape, dtype, gen, state_scale=0.0, dt_rank=256):
    """(x, dt, A, B, C, D, state) as the Mamba layer makes them, on
    ``gen``'s device: x ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1) -
    4) in f32 (the layer's dt_bias is -4); A = -exp(log(1..N)) and D = 1
    in f32, as ``init_mamba`` sets them; B and C are (b, s, N) column
    slices of one (b, s, dt_rank + 2N) projection ~ N(0, 1) in ``dtype``,
    as the layer hands them over; the state N(0, state_scale^2) in f32."""
    b, s, di, n = shape

    def randn(*size):
        return torch.randn(size, generator=gen, device=gen.device)

    x = randn(b, s, di).to(dtype)
    dt = F.softplus(randn(b, s, di) - 4.0)
    A = -torch.exp(torch.log(torch.arange(
        1, n + 1, dtype=torch.float32, device=gen.device))).expand(
        di, n).contiguous()
    proj = randn(b, s, dt_rank + 2 * n).to(dtype)
    B = proj[..., dt_rank:dt_rank + n]
    C = proj[..., dt_rank + n:]
    D = torch.ones(di, device=gen.device)
    state = randn(b, di, n) * state_scale
    return x, dt, A, B, C, D, state
