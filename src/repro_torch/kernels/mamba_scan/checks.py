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

The backward's gradients (``kernel_bwd``) are held row by row to their
scale, as K2's are (``bwd_row_scales``): the norm of the sum of the
magnitudes of the terms that make a row, the plain backward run on
|inputs| (with |A| as the factor of ddt's decay term; the decays
themselves are positive).  Rows: (b, t) of dx, ddt, dB, dC (over the
channels, or the N entries); c of dA (over N); dD whole; (b, c) of dh_0.
dB and dC sum 16384 channels of either sign, so a row's own norm can be
far below the rounding its terms carry.  Limits (``BWD_ROW_TOL``): 2e-5
for every f32 gradient -- both sides sum the same f32 terms in other
orders (the kernel's dB and dC in a tree of shuffles, warps and blocks;
dA and dD over t, then the batch) and form each decay with another
exponential (ex2.approx against ``torch.exp``, within 2 ulp), which g
carries over the ~100 steps a state remembers at the layer's init: ~1e-6
of the scale; in bf16, 1e-2 for dx, dB and dC, which both sides round to
bf16 (2^-9 of the element at most), and 2e-5 for ddt, dA, dD and dh_0,
which stay f32 from the same bf16 inputs.  Long-memory decays are held to
an f64 backward (``selective_scan_bwd_ref(..., compute=torch.float64)``)
as the forward's are: the kernel's rows no further from it than
``LONG_MEMORY_RATIO`` times the plain backward's, for the gradients that
carry the state; dD, a sum of dy x that carries none, keeps its f32
limit.  ``selective_scan_bwd_faulty`` gives the gradients with one fault
a kernel could make (``BWD_FAULTS``), each of which must land past the
limits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
STATE_TOL, STATE_ROW_TOL = 1e-4, 1e-5
LONG_MEMORY_RATIO = 2.0
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "ds0")
BWD_ROW_TOL = {torch.float32: dict.fromkeys(GRADS, 2e-5),
               torch.bfloat16: {**dict.fromkeys(GRADS, 2e-5),
                                "dx": 1e-2, "dB": 1e-2, "dC": 1e-2}}
# the gradients that carry no state, held to BWD_ROW_TOL also where the
# decays remember long
STATELESS = ("dD",)
# * "dB-one-block": dB summed over the first 64 channels only (one block
#   of the kernel's reverse pass);
# * "dA-late": dA from the state after the step, h_t, not h_{t-1};
# * "no-D-in-dx": dx without its D dy term;
# * "no-decay": the states recomputed without their decay, h_t = h_{t-1}
#   + dt x B.
BWD_FAULTS = ("dB-one-block", "dA-late", "no-D-in-dx", "no-decay")
ONE_BLOCK = 64


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


def bwd_inputs(shape, dtype, gen, state_scale=0.0, dstate_scale=0.0,
               **opts):
    """(x, dt, A, B, C, D, state, dy, dstate) for the backward: ``inputs``'
    forward inputs (``opts`` its options), dy ~ N(0, 1) in ``dtype`` and
    dstate N(0, dstate_scale^2) in f32 (None at 0)."""
    b, s, di, n = shape
    ins = inputs(shape, dtype, gen, state_scale, **opts)
    dy = torch.randn((b, s, di), generator=gen, device=gen.device).to(dtype)
    dstate = (torch.randn((b, di, n), generator=gen, device=gen.device)
              * dstate_scale if dstate_scale else None)
    return (*ins, dy, dstate)


def _reverse(x, dt, A, B, C, D, state, dy, dstate, fault=None,
             abs_A=False):
    """``selective_scan_bwd_ref``'s loop in f32 with ``fault``
    (``BWD_FAULTS``) or, with ``abs_A``, |A| as the factor of ddt's decay
    term."""
    xf, dtf, Af, Bf, Cf, Df, dyf = (t.float()
                                    for t in (x, dt, A, B, C, D, dy))
    h = state.float()
    hs = [h]
    for t in range(x.shape[1]):
        decay = (1.0 if fault == "no-decay"
                 else torch.exp(dtf[:, t, :, None] * Af))
        h = decay * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        hs.append(h)
    factor = Af.abs() if abs_A else Af
    G = torch.zeros_like(h) if dstate is None else dstate.float()
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    cut = ONE_BLOCK if fault == "dB-one-block" else x.shape[2]
    for t in reversed(range(x.shape[1])):
        e = torch.exp(dtf[:, t, :, None] * Af)
        g = G + dyf[:, t, :, None] * Cf[:, t, None, :]
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dyf[:, t])
        dB[:, t] = torch.einsum("bdn,bd->bn", g[:, :cut],
                                (dtf[:, t] * xf[:, t])[:, :cut])
        gB = torch.einsum("bdn,bn->bd", g, Bf[:, t])
        q = g * e * hs[t]
        dx[:, t] = dtf[:, t] * gB + (0.0 if fault == "no-D-in-dx"
                                     else Df * dyf[:, t])
        ddt[:, t] = (q * factor).sum(-1) + xf[:, t] * gB
        q_A = g * e * hs[t + 1] if fault == "dA-late" else q
        dA += torch.einsum("bdn,bd->dn", q_A, dtf[:, t])
        G = e * g
    return dx, ddt, dA, dB, dC, (dyf * xf).sum((0, 1)), G


def bwd_row_scales(x, dt, A, B, C, D, state, dy, dstate=None):
    """Per-row scale of each gradient of ``selective_scan_bwd_ref``, in
    ``GRADS``' order: the plain backward on the magnitudes of its inputs
    (dt >= 0 and the decays exp(dt A) > 0 already; |A| as ddt's factor),
    each gradient's norm over its last dim."""
    mags = _reverse(x.abs(), dt, A, B.abs(), C.abs(), D.abs(), state.abs(),
                    dy.abs(), None if dstate is None else dstate.abs(),
                    abs_A=True)
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


def bwd_long_memory(got, plain, exact, scales, dtype):
    """Long memory: {name: (kernel's worst row from the f64 backward
    ``exact``, the plain backward's, whether it holds)}: the kernel within
    ``LONG_MEMORY_RATIO`` times the plain backward's distance, or for
    ``STATELESS`` gradients within ``BWD_ROW_TOL`` of the plain one."""
    out = {}
    for name, g, p, x, m in zip(GRADS, got, plain, exact, scales):
        k_err, p_err = grad_row_err(g, x, m), grad_row_err(p, x, m)
        if name in STATELESS:
            ok = grad_row_err(g, p, m) <= BWD_ROW_TOL[dtype][name]
        else:
            ok = math.isfinite(k_err) and k_err <= LONG_MEMORY_RATIO * p_err
        out[name] = (k_err, p_err, ok)
    return out


def selective_scan_bwd_faulty(x, dt, A, B, C, D, state, dy, dstate, fault):
    """``selective_scan_bwd_ref``'s gradients with ``fault``
    (``BWD_FAULTS``), in f32."""
    if fault not in BWD_FAULTS:
        raise ValueError(f"no fault {fault!r}; one of {BWD_FAULTS}")
    return _reverse(x, dt, A, B, C, D, state, dy, dstate, fault=fault)


def f64_bwd(x, dt, A, B, C, D, state, dy, dstate=None):
    """The backward in f64 on the inputs' device, every gradient f64."""
    return selective_scan_bwd_ref(x, dt, A, B, C, D, state, dy, dstate,
                                  compute=torch.float64)
