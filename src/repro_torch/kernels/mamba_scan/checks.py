"""Inputs and limits for holding the selective scan kernel against its
plain version, shared by ``chip_smoke.py`` and the card-only tests.

Limits, as for WKV6: elementwise |out - ref| <= tol x (rms of ref +
|ref|), and ||out - ref|| / ||ref|| of every row.  y (rows (b, t), over
the channels): f32 2e-5 and 1e-5 -- both sides sum the same f32 terms in
other orders, and the kernel's exponential (ex2.approx of dt x A log2
e) is within 2 ulp of ``torch.exp``; bf16 1e-2 -- both
sides round the same f32 values to bf16, and where they round apart they
differ by one ulp (2^-8 relative), about 5e-4 of a row's norm (a CPU
estimate: the plain version against an f64 scan rounded to bf16, (2,
1024, 512, 16)).  The final state (rows (b, channel), f32 on both
sides): 1e-4 elementwise and 1e-5 by row.

The limits hold where a state entry forgets a step within about a
hundred steps, as at the layer's init.  Where it remembers much longer
(dt |A| ~ 1e-4), any two f32 scans drift apart by more, since a factor
e = exp(dt A) close to 1 carries a rounding of ~1e-7 that its
thousands of steps of memory multiply: with A_kind "long-memory" at (2,
512, 4096, 16) f32 the plain version on an H100 was 1.41e-5 by row from
an f64 scan in the final state, the kernel 1.74e-5, and 2.48e-5 from
each other (chip_smoke.py).  So such inputs are held to the
f64 scan (``f64_scan``) instead: the kernel no further from it than
twice the plain version (LONG_MEMORY_RATIO).

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
LONG_MEMORY_RATIO = 2.0


def inputs(shape, dtype, gen, state_scale=0.0, dt_rank=256, dt_bias=-4.0,
           dt_scale=1.0, A_kind="init"):
    """(x, dt, A, B, C, D, state) as the Mamba layer makes them, on
    ``gen``'s device: x ~ N(0, 1) in ``dtype``; dt = softplus(dt_scale *
    N(0, 1) + dt_bias) in f32 (the layer's dt_bias is -4); D = 1 in f32;
    A in f32 by ``A_kind``: "init" -exp(log(1..N)) in every row, as
    ``init_mamba`` sets it; "shuffled" each row a random order of
    -(1..N), each entry times U(1, 2), so no two rows are alike and none
    is -(1..N) (the memory stays that of the init); "long-memory"
    -exp(N(0, 1.5^2)) in every entry, decays that remember thousands of
    steps; B and C are (b, s, N) column slices of one (b, s, dt_rank +
    2N) projection ~ N(0, 1) in ``dtype``, as the layer hands them over;
    the state N(0, state_scale^2) in f32."""
    b, s, di, n = shape

    def randn(*size):
        return torch.randn(size, generator=gen, device=gen.device)

    x = randn(b, s, di).to(dtype)
    dt = F.softplus(randn(b, s, di) * dt_scale + dt_bias)
    if A_kind == "init":
        A = -torch.exp(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=gen.device))).expand(
            di, n).contiguous()
    elif A_kind == "shuffled":
        order = torch.rand((di, n), generator=gen,
                           device=gen.device).argsort(dim=1)
        scale = 1 + torch.rand((di, n), generator=gen, device=gen.device)
        A = -(order + 1).float() * scale
    elif A_kind == "long-memory":
        A = -torch.exp(randn(di, n) * 1.5)
    else:
        raise ValueError(f"no A_kind {A_kind!r}")
    proj = randn(b, s, dt_rank + 2 * n).to(dtype)
    B = proj[..., dt_rank:dt_rank + n]
    C = proj[..., dt_rank + n:]
    D = torch.ones(di, device=gen.device)
    state = randn(b, di, n) * state_scale
    return x, dt, A, B, C, D, state


def f64_scan(x, dt, A, B, C, D, state):
    """The scan in f64 on the inputs' device: (y (b, s, di), final state
    (b, di, N)), both f64."""
    xf, dtf, Af, Bf, Cf, Df = (t.double() for t in (x, dt, A, B, C, D))
    h = state.double()
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(dtf[:, t, :, None] * Af[None]) * h
             + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]) + Df * xf[:, t])
    return torch.stack(ys, dim=1), h
