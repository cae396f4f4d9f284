"""The PyTorch port's Mamba and Jamba on the CPU against the JAX package.

The port's plain selective scan (the version its dispatcher takes for CPU
tensors, and the one the CUDA kernel is held against on the card) against
the reference Pallas kernel in interpret mode and the reference oracle,
at the reference kernel tests' tolerances; the one-token step; the Mamba
mixer with bridged weights, with and without a carried state; ``JambaLM``
prefill and decode logits and cache for the smoke config and for the
structure of the 4-layer cut that ``chip_smoke.py`` serves (layers 4-7 of
a published period: attention + MLP, Mamba + MoE, Mamba + MLP, Mamba +
MoE); a mirror of the decode-vs-prefill checks; the dispatcher's
rules; the backward's plain version (``selective_scan_bwd_ref``) against
``jax.vjp`` of the reference's chunked twin and torch autograd, its
limits' faults, and ``_SelectiveScan``'s routing under ``JambaLM.loss``
with the kernels replaced by stand-ins that call ref.py.  Inputs come from numpy seeds.  The CUDA kernel itself runs only
on the card (``chip_smoke.py``, ``tests/test_torch_gpu.py``); here, what
surrounds it: a plain scan that forms its exponentials as the kernel
does against an f64 scan at the card checks' limits, its copy widths and
shared memory on meta tensors, its designs against the source, and its
two libraries' builds."""
from __future__ import annotations

import dataclasses
import hashlib
import math
import re
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.kernels.mamba_scan import ops as jops  # noqa: E402
from repro.kernels.mamba_scan.kernel import selective_scan_pallas  # noqa: E402
from repro.kernels.mamba_scan.ref import selective_scan_ref as jax_ref  # noqa: E402
from repro.models import mamba as jMB  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mamba_scan import checks  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as tK  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel_bwd as tKB  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as tops  # noqa: E402
from repro_torch.kernels.mamba_scan import ref as tref  # noqa: E402
from repro_torch.models import mamba as tMB  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402
from repro_torch.models.hybrid import JambaLM  # noqa: E402

ARCH = "jamba-1.5-large-398b"
# the cut chip_smoke.py serves, at smoke widths
CUT = dict(n_layers=4, attn_layer_period=4, attn_layer_offset=0)
# the reference kernel tests' tolerances (tests/test_kernels.py)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **tol)


def scan_inputs(b, s, di, N, dtype="float32", seed=0):
    """The reference kernel tests' distribution: x, B, C, D and the state
    uniform(-1, 1), dt = softplus(uniform) * 0.1, A = -exp(uniform(0,
    1)); x, dt, B and C in ``dtype``, A, D and the state in f32.  Returns
    (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)

    def uni(*shape, lo=-1.0):
        return rng.uniform(lo, 1, shape).astype(np.float32)

    x = uni(b, s, di)
    dt = (np.log1p(np.exp(uni(b, s, di))) * 0.1).astype(np.float32)
    A = -np.exp(uni(di, N, lo=0.0))
    B, C = uni(b, s, N), uni(b, s, N)
    D, h0 = uni(di), uni(b, di, N)
    dts = [dtype, dtype, "float32", dtype, dtype, "float32", "float32"]
    arrs = (x, dt, A, B, C, D, h0)
    return ([jnp.asarray(a).astype(JDT[d]) for a, d in zip(arrs, dts)],
            [torch.from_numpy(a).to(TDT[d]) for a, d in zip(arrs, dts)])


# ------------------------------------------------------------ the kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,N,chunk,bd", [
    (2, 40, 24, 8, 16, 16), (1, 100, 64, 16, 32, 32),
    (2, 33, 48, 4, 16, 48),
])
def test_plain_matches_pallas_kernel(b, s, di, N, chunk, bd, dtype):
    """The reference's own cases, ragged s included (padded time in the
    Pallas kernel, exactly s steps here)."""
    jin, tin = scan_inputs(b, s, di, N, dtype)
    y1, h1 = selective_scan_pallas(*jin, chunk=chunk, block_d=bd,
                                   interpret=True)
    y, h = tops.selective_scan(*tin)
    assert y.dtype == TDT[dtype] and y.shape == (b, s, di)
    assert h.dtype == torch.float32 and h.shape == (b, di, N)
    close(y1, y, TOL[dtype])
    close(h1, h, STATE_TOL)
    y2, h2 = jax_ref(*jin)
    close(y2, y, TOL[dtype])
    close(h2, h, TOL["float32"] if dtype == "float32" else STATE_TOL)


@pytest.mark.parametrize("s", [2, 37])
def test_plain_matches_oracle_on_strided_views(s):
    """B and C as column slices of one (b, s, r + 2N) projection, as the
    Mamba layer hands them over."""
    b, di, N, r = 2, 16, 8, 5
    jin, tin = scan_inputs(b, s, di, N, seed=7)
    proj = np.random.default_rng(8).uniform(
        -1, 1, (b, s, r + 2 * N)).astype(np.float32)
    tproj = torch.from_numpy(proj)
    tB, tC = tproj[..., r:r + N], tproj[..., r + N:]
    assert not tB.is_contiguous()
    x, dt, A, _, _, D, h0 = tin
    y, h = tops.selective_scan(x, dt, A, tB, tC, D, h0)
    jx, jdt, jA, _, _, jD, jh0 = jin
    y2, h2 = jax_ref(jx, jdt, jA, jnp.asarray(proj[..., r:r + N]),
                     jnp.asarray(proj[..., r + N:]), jD, jh0)
    close(y2, y, TOL["float32"])
    close(h2, h, TOL["float32"])


def test_step_matches_reference_step_and_scan():
    """The one-token decode step equals the reference's step and one step
    of the scan."""
    jin, tin = scan_inputs(2, 1, 16, 8, seed=3)
    x, dt, A, B, C, D, h0 = tin
    y, h = tops.selective_scan_step(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                                    D, h0)
    jx, jdt, jA, jB, jC, jD, jh0 = jin
    y1, h1 = jops.selective_scan_step(jx[:, 0], jdt[:, 0], jA, jB[:, 0],
                                      jC[:, 0], jD, jh0)
    close(y1, y, TOL["float32"])
    close(h1, h, TOL["float32"])
    y2, h2 = jax_ref(*jin)
    close(y2[:, 0], y, TOL["float32"])
    close(h2, h, TOL["float32"])


# -------------------------------------------------------- the dispatcher


def test_dispatch_counts_no_cpu_launches():
    _, tin = scan_inputs(1, 8, 16, 4)
    before = tops.launches
    tops.selective_scan(*tin)
    assert tops.launches == before


def test_dispatch_rejects_bad_input():
    _, (x, dt, A, B, C, D, h0) = scan_inputs(1, 8, 16, 4)
    with pytest.raises(ValueError, match=r"x, dt \(b,s,di\)"):
        tops.selective_scan(x, dt[:, :4], A, B, C, D, h0)
    with pytest.raises(ValueError, match="expected A"):
        tops.selective_scan(x, dt, A[:8], B, C, D, h0)
    with pytest.raises(ValueError, match="expected A"):
        tops.selective_scan(x, dt, A, B[..., :2], C, D, h0)
    with pytest.raises(ValueError, match="expected A"):
        tops.selective_scan(x, dt, A, B, C, D, h0[:, :, :2])
    with pytest.raises(ValueError, match="empty"):
        tops.selective_scan(x[:, :0], dt[:, :0], A, B[:, :0], C[:, :0], D,
                            h0)
    with pytest.raises(TypeError, match="floating"):
        tops.selective_scan(x.long(), dt, A, B, C, D, h0)
    before = tops.launches
    meta = [t.to("meta") for t in (x, dt, A, B, C, D, h0)]
    with pytest.raises(ValueError, match="different devices"):
        tops.selective_scan(*meta[:6], h0)
    with pytest.raises(ValueError, match="no selective_scan for device meta"):
        tops.selective_scan(*meta)
    assert tops.launches == before


def test_cpu_grad_takes_plain_version():
    _, (x, dt, A, B, C, D, h0) = scan_inputs(1, 6, 8, 4)
    x.requires_grad_(True)
    y, h = tops.selective_scan(x, dt, A, B, C, D, h0)
    (y.sum() + h.sum()).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_build_is_keyed_by_source_and_lazy():
    digest = hashlib.sha256(tK.SOURCE.read_bytes()).hexdigest()[:16]
    assert tK.library_path() == (_build.BUILD_ROOT
                                 / f"selective_scan-{digest}"
                                 / "libselective_scan.so")
    assert tK.library.cache_info().currsize == 0
    assert tK.SOURCE.name == "selective_scan.cu" and tK.SOURCE.exists()


# ------------------------------------------ the kernel's exponentials


def _close_like_the_card(out, ref, tol, row_tol):
    """chip_smoke.py's and the card tests' checks: elementwise |out - ref|
    <= tol x (rms of ref + |ref|), and ||out - ref|| / ||ref|| of every
    row (the last dim) <= row_tol."""
    out, ref = out.float(), ref.float()
    scale = ref.pow(2).mean().sqrt().item()
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol * scale)
    rows = ((out - ref).norm(dim=-1)
            / ref.norm(dim=-1).clamp_min(1e-30)).max().item()
    assert rows <= row_tol, rows
    return rows


def _ex2_ftz(x):
    """2^x in f32 with results below 2^-126 flushed to 0, as
    ``ex2.approx.ftz.f32`` gives them (to within its 2 ulp)."""
    y = torch.exp2(x)
    return torch.where(y < 2.0 ** -126, torch.zeros_like(y), y)


def _scan(x, dt, A, B, C, D, h):
    """A plain step loop in f32 with the kernel's factor: A scaled by
    log2 e once, its product with dt and the exponential of that in f32;
    returns (y rounded to x's dtype, final state)."""
    xf, dtf, Bf, Cf, Df = (t.float() for t in (x, dt, B, C, D))
    a2 = A.float() * torch.tensor(math.log2(math.e), dtype=torch.float32)
    h = h.float()
    ys = []
    for t in range(x.shape[1]):
        e = _ex2_ftz(dtf[:, t, :, None] * a2[None])
        h = e * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]) + Df * xf[:, t])
    return torch.stack(ys, 1).to(x.dtype), h


@pytest.mark.parametrize("opts", [{}, dict(dt_bias=6.0, dt_scale=2.0),
                                  dict(A_kind="shuffled"),
                                  dict(A_kind="long-memory")],
                         ids=["layer-init", "large-dt", "shuffled-A",
                              "long-memory"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_scan_with_the_kernels_exponential_matches_an_f64_scan(
        dtype, opts):
    """The scan with each factor formed as the kernel forms it (2^(dt x
    (A log2 e)) in f32, flushed to 0 below 2^-126) against an f64 scan, at
    (2, 1024, 512, 16): inside every limit of checks.py (y by dtype; the
    f32 state 1e-4 elementwise, 1e-5 by row).  At large dt the flush
    takes effect on more than 1% of the entries."""
    gen = torch.Generator().manual_seed(11)
    args = checks.inputs((2, 1024, 512, 16), dtype, gen, 10.0, **opts)
    y, h = _scan(*args)
    y64, h64 = checks.f64_scan(*args)
    _close_like_the_card(y, y64.to(dtype), checks.TOL[dtype],
                         checks.ROW_TOL[dtype])
    _close_like_the_card(h, h64, checks.STATE_TOL, checks.STATE_ROW_TOL)
    if opts.get("dt_bias"):
        x, dt, A = args[:3]
        assert (dt[..., None] * A * math.log2(math.e) < -126).float() \
            .mean() > 0.01


# ------------------------------------------------ the kernel's designs


def _outside_sweep_blocks(src):
    """The source with its comments and its ``#ifdef SCAN_SWEEP ...
    #endif`` blocks cut out: what the serving library compiles."""
    code = re.sub(r"//[^\n]*", "", src)
    return re.sub(r"#ifdef SCAN_SWEEP\n.*?#endif", "", code, flags=re.S)


def test_serving_library_holds_the_design_alone():
    """The serving library holds ``DESIGN``, the pipelined kernel, and
    neither the first design nor the ex2 probe: those are compiled only
    with -DSCAN_SWEEP.  The C entry's design numbers are ``KINDS``'."""
    assert tK.DESIGN == "pipe" and tK.fits(tK.DESIGN)
    assert tK.fits(tK.DESIGN, sweep=True)
    for yard in ("first", "first-ex2"):
        assert not tK.fits(yard) and tK.fits(yard, sweep=True)
    src = tK.SOURCE.read_text()
    serving = _outside_sweep_blocks(src)
    assert "scan_pipe_kernel" in serving
    for name in ("scan_kernel", "launch_first", "ex2_probe_kernel",
                 "ex2_rate_probe"):
        assert name in src and name not in serving, name
    assert f"design == {tK.KINDS['pipe']}" in serving
    assert f"design == {tK.KINDS['first']} || design == " \
        f"{tK.KINDS['first-ex2']}" in src


def test_ex2_probes_match_the_source():
    """The ex2 probe's (FFMAs, LDS.128) pairs are the source's
    ``SCAN_PROBES``: the SFU alone, then with 8 FFMAs beside each ex2
    (chip_smoke.py fits a MUFU's dispatch slots from it); a pair it lacks
    raises before any launch."""
    found = re.search(r"#define SCAN_PROBES\(X\)(.*)",
                      tK.SOURCE.read_text()).group(1)
    assert tuple((int(f), int(ld)) for f, ld in re.findall(
        r"X\((\d+), (\d+)\)", found)) == tK.PROBES
    assert tK.PROBES == ((0, 0), (8, 0))
    with pytest.raises(ValueError, match="no ex2 probe with 3 FFMAs"):
        tK.ex2_rate(fmas=3)
    assert tK.library.cache_info().currsize == 0


def test_candidates_are_the_yardsticks_then_the_design():
    """chip_smoke.py times the first design, the same with ex2.approx,
    then ``DESIGN``, each in the sweep library and none twice."""
    assert tK.CANDIDATES == ("first", "first-ex2", tK.DESIGN)
    assert set(tK.CANDIDATES) == set(tK.KINDS)
    assert all(tK.fits(c, sweep=True) for c in tK.CANDIDATES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_shared_memory_keeps_the_blocks_resident(n, dtype):
    """A block fits the 227 KB a block may have; at the main path's types
    (bf16, N = 16) a block is 56 KB, so 4 blocks (and their 1 KB of
    reserved shared memory each) fit an SM's 228 KB: the main path's 512
    blocks of 128 channels in one wave on 132 SMs."""
    size = tK.smem_bytes(dtype, n)
    assert size % 16 == 0 and size <= 227 * 1024
    if dtype == torch.bfloat16 and n == 16:
        assert size == 57344
        assert 4 * (size + 1024) <= 228 * 1024
        assert 4 * 132 >= 4 * -(-16384 // tK.CHANNELS)


@pytest.mark.parametrize("shape,dtype,view,width", [
    ((4, 1024, 16384), torch.bfloat16, None, 16),     # the main path's x
    ((4, 1024, 16384), torch.float32, None, 16),      # and dt
    ((2, 33, 1000), torch.bfloat16, None, 16),
    ((2, 33, 1004), torch.bfloat16, None, 8),
    ((2, 33, 1002), torch.bfloat16, None, 4),
    ((2, 65, 999), torch.bfloat16, None, 2),
    ((1, 100, 130), torch.float32, None, 8),
    ((3, 37, 201), torch.float32, None, 4),
    ((2, 40, 64), torch.bfloat16, "offset", 2),       # a view 1 element in
    ((2, 40, 64), torch.float32, "offset", 4),
    ((2, 40, 64), torch.bfloat16, "columns", 16),     # x[..., :32] of 64
])
def test_copy_width_on_meta_tensors(shape, dtype, view, width):
    """The bytes of each cp.async unit, before any launch: the largest of
    16, 8, 4 that divides the address and the batch and step strides; 2
    for bf16 that 4 does not divide; never less than the element."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    if view == "offset":
        t = torch.empty(t.numel() + 1, dtype=dtype, device="meta")[1:] \
            .view(shape)
    elif view == "columns":
        t = t[..., :32]
    assert t.stride(-1) == 1
    assert tK.copy_width(t) == width


@pytest.mark.parametrize("sweep", [False, True], ids=["serving", "sweep"])
@pytest.mark.parametrize("design", ["other", "pipe-c16", "", "PIPE",
                                    "first-exp2", 2])
def test_selective_scan_cuda_rejects_designs_it_has_no_kernel_for(design,
                                                                  sweep):
    """Before any launch (on CPU tensors, with no library built), a
    design outside the library raises, in both libraries; the first design
    is not in the serving library."""
    _, tin = scan_inputs(1, 8, 16, 4)
    with pytest.raises(ValueError, match="no selective_scan design"):
        tK.selective_scan_cuda(*tin, design=design, sweep=sweep)
    if not sweep:
        with pytest.raises(ValueError, match="in the serving library"):
            tK.selective_scan_cuda(*tin, design="first")
    assert tK.library.cache_info().currsize == 0


FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: logs its call and writes the file after -o
echo "$@" >> "{log}"
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo lib > "$2"; fi
  shift
done
echo "ptxas info    : Used 40 registers"
"""


def test_sweep_library_is_its_own_build(tmp_path, monkeypatch):
    """The sweep library has a name of its own beside the serving one,
    keyed by the same source, and only its build passes -DSCAN_SWEEP."""
    log = tmp_path / "calls.log"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", "/usr/bin:/bin")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    digest = hashlib.sha256(tK.SOURCE.read_bytes()).hexdigest()[:16]
    assert tK.library_path(sweep=True) == (
        _build.BUILD_ROOT / f"selective_scan_sweep-{digest}"
        / "libselective_scan_sweep.so")
    assert tK.build() == tK.library_path()
    assert tK.build(sweep=True) == tK.library_path(sweep=True)
    serving, sweep = log.read_text().splitlines()
    assert "-DSCAN_SWEEP" not in serving and "-DSCAN_SWEEP" in sweep
    assert tK.library.cache_info().currsize == 0


# ------------------------------------------------------------ the mixer


def perturbed(params, seed):
    """The reference init leaves conv_b at 0, dt_bias at -4, A_log at
    log(1..N), D at 1 and the norm scales at 1: add noise to them,
    identically for both packages, so their paths are checked."""
    rng = np.random.default_rng(seed)
    noisy = {"conv_b": 0.3, "dt_bias": 0.5, "A_log": 0.3, "D": 0.5,
             "scale": 0.2}

    def fn(path, leaf):
        scale = noisy.get(path[-1].key)
        if scale is None:
            return leaf
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * scale
        return (leaf.astype(jnp.float32) + noise).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fn, params)


def bridged(tree):
    return params_from_flat({k: np.asarray(v) for k, v in _flatten(tree)})


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("s", [1, 2, 9])
def test_apply_mamba_matches_reference(s, carried):
    """s = 1 takes the step path, s = 2 is shorter than the conv's K - 1
    = 3 rows of state, s = 9 longer."""
    cfg = get_smoke(ARCH).replace(dtype="float32")
    tcfg = torch_smoke(ARCH).replace(dtype="float32")
    jp = perturbed(jMB.init_mamba(jax.random.PRNGKey(4), cfg, jnp.float32),
                   5)
    tp = bridged(jp)
    b, d = 2, cfg.d_model
    di, N, K = 2 * d, cfg.mamba.d_state, cfg.mamba.d_conv
    g = np.random.default_rng(6)
    x = g.standard_normal((b, s, d)).astype(np.float32)
    jst = tst = None
    if carried:
        ssm = g.standard_normal((b, di, N)).astype(np.float32)
        conv = g.standard_normal((b, K - 1, di)).astype(np.float32)
        jst = {"ssm": jnp.asarray(ssm), "conv": jnp.asarray(conv)}
        tst = {"ssm": torch.from_numpy(ssm), "conv": torch.from_numpy(conv)}
    jy, jnew = jMB.apply_mamba(jnp.asarray(x), jp, cfg, jst)
    before = tops.launches
    ty, tnew = tMB.apply_mamba(torch.from_numpy(x), tp, tcfg, tst)
    assert tops.launches == before
    close(jy, ty, TOL["float32"])
    close(jnew["ssm"], tnew["ssm"], TOL["float32"])
    close(jnew["conv"], tnew["conv"], TOL["float32"])


def test_apply_mamba_bf16_keeps_the_reference_dtypes():
    """bf16 model: dt and the ssm state are f32, the conv state bf16."""
    cfg = get_smoke(ARCH)
    jp = perturbed(jMB.init_mamba(jax.random.PRNGKey(7), cfg,
                                  jnp.bfloat16), 8)
    tp = bridged(jp)
    assert tp["A_log"].dtype == torch.float32
    assert tp["D"].dtype == torch.float32
    assert tp["in_proj"].dtype == torch.bfloat16
    x = np.random.default_rng(9).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    jy, jnew = jMB.apply_mamba(jnp.asarray(x).astype(jnp.bfloat16), jp, cfg)
    ty, tnew = tMB.apply_mamba(torch.from_numpy(x).bfloat16(), tp,
                               torch_smoke(ARCH))
    assert ty.dtype == torch.bfloat16
    assert tnew["ssm"].dtype == torch.float32
    assert tnew["conv"].dtype == torch.bfloat16
    close(jy, ty, TOL["bfloat16"])
    close(jnew["ssm"], tnew["ssm"], TOL["bfloat16"])
    close(jnew["conv"], tnew["conv"], TOL["bfloat16"])


# --------------------------------------------------------------- JambaLM


def model_pair(dtype="float32", seed=0, **replace):
    jm = jax_build(get_smoke(ARCH).replace(dtype=dtype, **replace))
    jp = perturbed(jm.init(jax.random.PRNGKey(seed)), seed + 10)
    tm = torch_build(torch_smoke(ARCH).replace(dtype=dtype, **replace))
    assert isinstance(tm, JambaLM)
    assert (tm.moe_js, tm.mlp_js, tm.n_mamba) == (jm.moe_js, jm.mlp_js,
                                                  jm.n_mamba)
    return jm, jp, tm, bridged(jp)


def close_cache(jcache, tcache, tol):
    for path, leaf in _flatten(jcache):
        node = tcache
        for key in path.split("/"):
            node = node[key]
        close(leaf, node, tol)


@pytest.mark.parametrize("replace", [{}, CUT], ids=["smoke", "cut"])
def test_prefill_decode_match_reference(replace):
    """Logits and the whole cache (attention k/v, Mamba ssm and conv
    states) after prefill and after each of three decode steps, f32 at
    2e-5."""
    jm, jp, tm, tp = model_pair(**replace)
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jcache, jlen = jax.jit(lambda p, t: jm.prefill(p, t, 28))(
        jp, jnp.asarray(toks))
    before = tops.launches
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 28)
    assert tops.launches == before                # the CPU: plain scan
    assert tl.shape == (2, 1, jm.cfg.vocab_size) and tlen == int(jlen) == 20
    close(jl, tl, TOL["float32"])
    close_cache(jcache, tcache, TOL["float32"])
    step = jax.jit(jm.decode)
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for _ in range(3):
        jl, jcache, jlen = step(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            ssm = tcache["mamba"]["ssm"]
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
            assert tcache["mamba"]["ssm"] is ssm     # updated in place
        assert tlen == int(jlen)
        close(jl, tl, TOL["float32"])
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    close_cache(jcache, tcache, TOL["float32"])


def test_decode_past_max_len_matches_reference():
    """An 8-token prompt into a cache of max_len 8, then two decode steps
    past its end: the attention layer's writes clamp to the last slot as
    the reference's dynamic_update_slice does; logits, lengths and the
    whole cache match, f32 at 2e-5."""
    jm, jp, tm, tp = model_pair(seed=3)
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jcache, jlen = jm.prefill(jp, jnp.asarray(toks), 8)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 8)
    close(jl, tl, TOL["float32"])
    nxt = np.array([[3], [11]], np.int32)
    for want in (9, 10):
        jl, jcache, jlen = jm.decode(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
        assert tlen == int(jlen) == want
        assert torch.isfinite(tl).all()
        close(jl, tl, TOL["float32"])
        nxt = nxt + 1
    close_cache(jcache, tcache, TOL["float32"])


def test_one_token_prompt_takes_the_step_path():
    jm, jp, tm, tp = model_pair(seed=2, **CUT)
    toks = np.array([[5], [9]], np.int32)
    jl, jcache, _ = jm.prefill(jp, jnp.asarray(toks), 4)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 4)
    assert tlen == 1
    close(jl, tl, TOL["float32"])
    close_cache(jcache, tcache, TOL["float32"])


def test_bf16_prefill_matches_reference():
    jm, jp, tm, tp = model_pair("bfloat16", seed=3, **CUT)
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _, _ = jm.prefill(jp, jnp.asarray(toks), 16)
    with torch.inference_mode():
        tl, _, _ = tm.prefill(tp, torch.from_numpy(toks), 16)
    assert tl.dtype == torch.bfloat16
    close(jl, tl, TOL["bfloat16"])


def full_logits(model, params, toks):
    """Logits at every position from one cache-free forward."""
    from repro_torch.models import common as tC
    from repro_torch.models import layers as tL
    x = tC.embed(toks, params["embed"], model.cfg)
    pos = torch.arange(x.shape[1])[None, :]
    x = model._run_layers(x, params, pos, None, None, "train")[0]
    x = tL.apply_norm(x, params["final_norm"], model.cfg)
    return tC.lm_logits(x, params["embed"], model.cfg)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2),
                                       ("float32", 1e-4)])
def test_decode_matches_prefill_jamba(dtype, tol):
    """Torch mirror of the reference's decode-vs-prefill checks:
    teacher-forced decode (the attention cache and the Mamba states)
    reproduces the logits of one cache-free forward (bf16 at the
    reference's 2e-2).  Capacity factor 16, so that neither side drops a
    token (a forward of 12 tokens and a decode step of one fill the
    experts differently)."""
    cfg = torch_smoke(ARCH).replace(dtype=dtype, **CUT)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    tm = torch_build(cfg)
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 12)))
    with torch.inference_mode():
        ref = full_logits(tm, tp, toks).float()
        logits, cache, length = tm.prefill(tp, toks[:, :6], 16)
        torch.testing.assert_close(logits[:, 0].float(), ref[:, 5],
                                   rtol=tol, atol=tol)
        for i in range(6, 11):
            logits, cache, length = tm.decode(tp, cache, toks[:, i:i + 1],
                                              length)
            torch.testing.assert_close(logits[:, 0].float(), ref[:, i],
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("replace", [{}, CUT], ids=["smoke", "cut"])
def test_init_and_cache_layout_match_reference(replace):
    """Seeded initialisers: the same names, shapes and dtypes as the
    reference's, and the cache layout of ``init_cache``."""
    jm = jax_build(get_smoke(ARCH).replace(**replace))
    tm = torch_build(torch_smoke(ARCH).replace(**replace))
    jflat = dict(_flatten(jax.eval_shape(jm.init, jax.random.PRNGKey(0))))
    tflat = dict(_flatten_torch(tm.init(torch.Generator().manual_seed(0),
                                        "cpu")))
    assert sorted(jflat) == sorted(tflat)
    for key, leaf in jflat.items():
        assert tuple(leaf.shape) == tuple(tflat[key].shape), key
        assert str(leaf.dtype) == str(tflat[key].dtype)[6:], key
    jcache = dict(_flatten(jm.init_cache(3, 10)))
    tcache = dict(_flatten_torch(tm.init_cache(3, 10, "cpu")))
    assert sorted(jcache) == sorted(tcache)
    for key, leaf in jcache.items():
        assert tuple(leaf.shape) == tuple(tcache[key].shape), key
        assert str(leaf.dtype) == str(tcache[key].dtype)[6:], key


def _flatten_torch(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten_torch(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_long_context_windows_the_attention_layer():
    """``long_context`` passes the config's window to the attention
    layer, as the reference does."""
    jm = jax_build(get_smoke(ARCH).replace(dtype="float32"),
                   long_context=True)
    jp = jm.init(jax.random.PRNGKey(5))
    tm = torch_build(torch_smoke(ARCH).replace(dtype="float32"),
                     long_context=True)
    assert tm.attn_window == jm.attn_window == 16
    toks = np.random.default_rng(6).integers(
        0, jm.cfg.vocab_size, (1, 30)).astype(np.int32)
    jl, _, _ = jm.prefill(jp, jnp.asarray(toks), 32)
    with torch.inference_mode():
        tl, _, _ = tm.prefill(bridged(jp), torch.from_numpy(toks), 32)
    close(jl, tl, TOL["float32"])



# ------------------------------------------------------------ the backward


def bwd_np(b, s, di, N, seed, dt_zero=False, long_memory=False):
    """numpy f32 inputs for the backward, each uniform(-1, 1) but for dt =
    softplus(uniform) * 0.1 (with ``dt_zero`` a quarter of the entries
    exactly 0) and A = -exp(uniform(0, 1)) (with ``long_memory`` -exp(1.5
    N(0, 1)): decays from ~1e-4 to ~90 a unit of dt); B and C are column
    slices of one (b, s, 3 + 2N) projection.  Returns (x, dt, A, proj, D,
    state, dy, dstate)."""
    rng = np.random.default_rng(seed)

    def uni(*shape, lo=-1.0):
        return rng.uniform(lo, 1, shape).astype(np.float32)

    x = uni(b, s, di)
    dt = (np.log1p(np.exp(uni(b, s, di))) * 0.1).astype(np.float32)
    if dt_zero:
        dt[rng.random((b, s, di)) < 0.25] = 0.0
    if long_memory:
        A = -np.exp(1.5 * rng.standard_normal((di, N))).astype(np.float32)
    else:
        A = -np.exp(uni(di, N, lo=0.0))
    proj = uni(b, s, 3 + 2 * N)
    return x, dt, A, proj, uni(di), uni(b, di, N), uni(b, s, di), \
        uni(b, di, N)


def split(proj, N):
    """B and C, the projection's column slices (views in torch)."""
    return proj[..., 3:3 + N], proj[..., 3 + N:]


BWD_CASES = [(6, {}), (130, {}), (130, dict(dt_zero=True)),
             (130, dict(long_memory=True))]
BWD_IDS = ["s6", "s130", "s130-dt-0", "s130-long-memory"]


def close_grads(want, got, tol=2e-5):
    """Each gradient within ``tol`` relative and ``tol`` of its largest
    |value| (dB and dC sum over every channel: an elementwise limit at the
    smallest entries would hold rounding to a bare 2e-5)."""
    for name, a, b in zip(checks.GRADS, want, got):
        a = np.asarray(a, np.float32)
        b = b.detach().float().numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), name
        np.testing.assert_allclose(b, a, rtol=tol,
                                   atol=tol * np.abs(a).max(), err_msg=name)


@pytest.mark.parametrize("s,opts", BWD_CASES, ids=BWD_IDS)
def test_bwd_ref_matches_jax_vjp(s, opts):
    """selective_scan_bwd_ref against jax.vjp of the reference's chunked
    twin (the one it trains through: s = 130 pads to two 128-step chunks
    with dt = 0), with nonzero h_0 and dh_T, B and C strided slices of one
    projection, f32 at 2e-5; every gradient finite."""
    N = 4
    x, dt, A, proj, D, h0, dy, dh = bwd_np(2, s, 8, N, seed=30 + s, **opts)
    jB, jC = split(jnp.asarray(proj), N)
    ins = [jnp.asarray(a) for a in (x, dt, A)] + [jB, jC] + [
        jnp.asarray(a) for a in (D, h0)]
    _, vjp = jax.vjp(jops.selective_scan_chunked, *ins)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    tp = torch.from_numpy(proj)
    B, C = split(tp, N)
    assert B.stride(1) == 3 + 2 * N
    got = tref.selective_scan_bwd_ref(
        *(torch.from_numpy(a) for a in (x, dt, A)), B, C,
        *(torch.from_numpy(a) for a in (D, h0, dy, dh)))
    close_grads(want, got)


@pytest.mark.parametrize("s,opts", BWD_CASES, ids=BWD_IDS)
def test_bwd_ref_matches_autograd(s, opts):
    """selective_scan_bwd_ref against torch autograd of selective_scan_ref
    (gradients of the projection's slices through the view), with nonzero
    h_0 and dh_T, f32 at 2e-5."""
    N = 4
    x, dt, A, proj, D, h0, dy, dh = (torch.from_numpy(a) for a in bwd_np(
        2, s, 8, N, seed=50 + s, **opts))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, proj, D, h0)]
    B, C = split(leaves[3], N)
    y, h = tref.selective_scan_ref(*leaves[:3], B, C, *leaves[4:])
    gx, gdt, gA, gproj, gD, gh0 = torch.autograd.grad((y, h), leaves,
                                                      (dy, dh))
    want = (gx, gdt, gA, *split(gproj, N), gD, gh0)
    got = tref.selective_scan_bwd_ref(x, dt, A, *split(proj, N), D, h0, dy,
                                      dh)
    close_grads([w.numpy() for w in want], got)
    assert not gproj[..., :3].any()


def test_bwd_ref_in_f32_holds_to_f64_at_long_memory():
    """At long memory the plain backward in f32 stays within its f32 row
    limits of the same backward in f64 (the yardstick the card holds the
    kernel to there), and ``bwd_long_memory`` accepts it."""
    gen = torch.Generator().manual_seed(3)
    *args, dy, ds = checks.bwd_inputs((2, 200, 64, 16), torch.float32, gen,
                                      10.0, 1.0, A_kind="long-memory")
    plain = tref.selective_scan_bwd_ref(*args, dy, ds)
    exact = checks.f64_bwd(*args, dy, ds)
    assert all(g.dtype == torch.float64 for g in exact)
    scales = checks.bwd_row_scales(*args, dy, ds)
    assert checks.bwd_within(checks.bwd_errors(plain, exact, scales),
                             torch.float32)
    held = checks.bwd_long_memory(plain, plain, exact, scales,
                                  torch.float32)
    assert all(ok for _, _, ok in held.values())


@pytest.mark.parametrize("fault", checks.BWD_FAULTS)
def test_bwd_faults_fail_the_limits(fault):
    """Each fault of checks.py lands past its gradient's f32 limit by more
    than 10x, while the plain backward's own gradients rounded to bf16
    stay within the bf16 limits."""
    gen = torch.Generator().manual_seed(7)
    ins = checks.bwd_inputs((2, 64, 192, 16), torch.float32, gen, 10.0, 1.0)
    ref = tref.selective_scan_bwd_ref(*ins)
    scales = checks.bwd_row_scales(*ins)
    bad = checks.selective_scan_bwd_faulty(*ins, fault)
    errs = checks.bwd_errors(bad, ref, scales)
    limits = checks.BWD_ROW_TOL[torch.float32]
    assert not checks.bwd_within(errs, torch.float32)
    assert max(e / limits[g] for g, e in errs.items()) > 10, errs
    rounded = [g.to(torch.bfloat16) if name in ("dx", "dB", "dC") else g
               for name, g in zip(checks.GRADS, ref)]
    assert checks.bwd_within(checks.bwd_errors(rounded, ref, scales),
                             torch.bfloat16)
    with pytest.raises(ValueError, match="no fault"):
        checks.selective_scan_bwd_faulty(*ins, "no-such-fault")


@pytest.fixture
def stand_ins(monkeypatch):
    """The kernel entry points replaced by CPU stand-ins that call
    ref.py, and ops.selective_scan's CPU tensors routed through
    ``_SelectiveScan`` as CUDA tensors are: this tests the routing, not
    the kernels.  Returns the record of the stand-ins' calls, in order."""
    calls = []
    ref_fwd, ref_bwd = tref.selective_scan_ref, tref.selective_scan_bwd_ref

    def forward(x, dt, A, B, C, D, state, design=tK.DESIGN, sweep=False,
                checkpoints=None):
        calls.append(("fwd", (x, dt, A, B, C, D, state), checkpoints))
        if checkpoints is not None:
            checkpoints.zero_()[..., :A.shape[1]] = \
                tref.selective_scan_checkpoints(x, dt, A, B, state,
                                                tK.CK_STEPS)
        return ref_fwd(x, dt, A, B, C, D, state)

    def backward(x, dt, A, B, C, D, state, dy, dstate=None, kernels=None,
                 checkpoints=None, design=tKB.DESIGN, sweep=False):
        calls.append(("bwd", (x, dt, A, B, C, D, state, dy, dstate),
                      checkpoints))
        g = ref_bwd(x, dt, A, B, C, D, state, dy, dstate)
        return (g[0].to(x.dtype), *g[1:3], g[3].to(x.dtype),
                g[4].to(x.dtype), *g[5:])

    def routed(x, dt, A, B, C, D, state):
        tops._check(x, dt, A, B, C, D, state)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, dt, A, B, C, D, state)):
            return tops._SelectiveScan.apply(x, dt, A, B, C, D, state)
        return tops._forward(x, dt, A, B, C, D, state)

    monkeypatch.setattr(tK, "selective_scan_cuda", forward)
    monkeypatch.setattr(tKB, "selective_scan_bwd_cuda", backward)
    monkeypatch.setattr(tKB, "forward_checkpoints", None)
    monkeypatch.setattr(tops, "selective_scan", routed)
    return calls


@pytest.mark.parametrize("with_state_grad", [False, True])
def test_function_launches_and_saves_its_inputs(stand_ins, with_state_grad):
    """``_SelectiveScan``: one forward launch, the backward's kernels
    counted once, the backward handed the very tensors the forward saved
    (B and C as the projection's views) and dh_T only where the final
    state is used; its gradients are autograd's of selective_scan_ref."""
    N = 4
    x, dt, A, proj, D, h0, dy, dh = (torch.from_numpy(a) for a in bwd_np(
        2, 9, 8, N, seed=3))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, proj, D, h0)]

    def run(fn):
        B, C = split(leaves[3], N)
        y, h = fn(*leaves[:3], B, C, *leaves[4:])
        outs, grads = ((y, h), (dy, dh)) if with_state_grad else ((y,),
                                                                  (dy,))
        return torch.autograd.grad(outs, leaves, grads)

    before = (tops.launches, tops.launches_bwd)
    got = run(tops.selective_scan)
    assert (tops.launches - before[0], tops.launches_bwd - before[1]) == (
        1, len(tKB.KERNELS))
    assert [c[0] for c in stand_ins] == ["fwd", "bwd"]
    fwd_args, bwd_args = stand_ins[0][1], stand_ins[1][1]
    for a, b in zip(fwd_args, bwd_args[:7]):
        assert a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
    assert bwd_args[3].stride(1) == 3 + 2 * N
    assert (bwd_args[8] is None) != with_state_grad
    want = run(tref.selective_scan_ref)
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=2e-5, atol=2e-5)


def test_remat_recomputes_the_saved_inputs(stand_ins):
    """JambaLM.loss with each period under activation checkpointing: the
    forward launches twice a Mamba layer (the forward, then its period's
    recompute in the backward), each backward is handed the inputs its
    layer's recompute saved, and loss and gradients equal those without
    remat, bit for bit."""
    from repro_torch import tree as T
    from repro_torch.training.step import value_and_grad
    _, _, tm, tp = model_pair(seed=4)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tm.cfg.vocab_size, (2, 21)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n, m = tm.n_periods, tm.n_mamba

    class NoRemat(JambaLM):
        def _run_layers(self, *a, remat=False):
            return super()._run_layers(*a, remat=False)

    loss0, _, grads0 = value_and_grad(NoRemat(tm.cfg), tp, batch)
    stand_ins.clear()
    loss, _, grads = value_and_grad(tm, tp, batch)
    kinds = [c[0] for c in stand_ins]
    assert kinds == ["fwd"] * n * m + (["fwd"] * m + ["bwd"] * m) * n
    for p in range(n):
        start = n * m + 2 * m * p
        recompute = stand_ins[start:start + m]
        handed = stand_ins[start + m:start + 2 * m]
        for r, h in zip(reversed(recompute), handed):
            for a, b in zip(r[1], h[1][:7]):
                assert a.data_ptr() == b.data_ptr()
    assert torch.equal(loss, loss0)
    for (path, g), g0 in zip(T.flatten(grads), T.leaves(grads0)):
        assert torch.equal(g, g0), path


def test_backward_library_is_its_own_lazy_build():
    """The backward is a library of its own, keyed by its source's hash,
    built at first use (not at import), and its layout constants are the
    source's."""
    digest = hashlib.sha256(tKB.SOURCE.read_bytes()).hexdigest()[:16]
    assert _build.library_path(tKB.SOURCE, tKB.NAME) == (
        _build.BUILD_ROOT / f"selective_scan_bwd-{digest}"
        / "libselective_scan_bwd.so")
    assert tKB.library.cache_info().currsize == 0
    src = tKB.SOURCE.read_text()
    for name, value in (("K", tKB.CK_STEPS), ("CH", tKB.CHANNELS),
                        ("LANES", tKB.LANES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert tKB.checkpoint_shape((4, 2048, 16384, 16)) == (4, 128, 16384, 16)
    assert tKB.partials_shape((4, 2048, 16384, 16)) == (4, 2048, 256, 32)
    assert tKB.checkpoint_shape((3, 37, 200, 3)) == (3, 3, 200, 4)
    assert tKB.partials_shape((3, 37, 200, 5)) == (3, 37, 4, 16)


def test_backward_refuses_cpu_tensors():
    """The backward's entry takes CUDA tensors only, and refuses before
    any launch."""
    gen = torch.Generator().manual_seed(1)
    *args, dy, ds = checks.bwd_inputs((1, 8, 16, 4), torch.float32, gen)
    before = tKB.library.cache_info().currsize
    with pytest.raises(ValueError, match="selective_scan_bwd takes"):
        tKB.selective_scan_bwd_cuda(*args, dy, ds)
    assert tKB.library.cache_info().currsize == before


# ------------------------------------------ the backward's design, by layout


def _source_constant(src, name):
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def test_checkpoint_layout_is_the_sources():
    """The training mode's checkpoints: every CK_STEPS = 16 steps in the
    forward's source (CK) and the backward's (K), (b, ceil(s / 16), di,
    padded N) f32; 537 MB at the training shape (4, 2048, 16384, 16)."""
    assert tK.CK_STEPS == tKB.CK_STEPS == 16
    assert _source_constant(tK.SOURCE.read_text(), "CK") == tK.CK_STEPS
    assert _source_constant(tKB.SOURCE.read_text(), "K") == tKB.CK_STEPS
    shape = tKB.checkpoint_shape((4, 2048, 16384, 16))
    assert shape == tK.checkpoint_shape((4, 2048, 16384, 16)) == (
        4, 128, 16384, 16)
    assert math.prod(shape) * 4 == 536870912
    assert tKB.checkpoint_shape((2, 37, 200, 5)) == (2, 3, 200, 8)
    assert tKB.checkpoint_shape((1, 16, 64, 4)) == (1, 1, 64, 4)
    assert tKB.checkpoint_shape((1, 17, 64, 4)) == (1, 2, 64, 4)


@pytest.mark.parametrize("s", [1, 15, 16, 17, 37, 1000, 2047, 2048])
def test_sub_chunks_cover_the_sequence_exactly(s):
    """The reverse pass walks ceil(s / 16) sub-chunks, last first, one a
    checkpoint: each starts at a multiple of 16, none overlaps another,
    together they cover steps 0 .. s - 1, and only the last (the first
    walked) may be ragged."""
    chunks = tKB.sub_chunks(s)
    assert len(chunks) == tKB.checkpoint_shape((1, s, 1, 16))[1]
    steps = [t for t0, n in reversed(chunks) for t in range(t0, t0 + n)]
    assert steps == list(range(s))
    assert all(t0 % tKB.CK_STEPS == 0 and 1 <= n <= tKB.CK_STEPS
               for t0, n in chunks)
    assert [t0 for t0, _ in chunks] == sorted(
        (t0 for t0, _ in chunks), reverse=True)
    assert all(n == tKB.CK_STEPS for _, n in chunks[1:])
    assert chunks[0][1] == s - tKB.CK_STEPS * (len(chunks) - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_reverse_pass_budgets(n, dtype):
    """Two blocks of the reverse pass fit an SM: its shared memory (the
    warps' sums of a sub-chunk, the packed rows, B and C in the lane
    orders, the next sub-chunk's copies) twice with each block's reserved
    1 KB, and 128 registers a thread, of which the stashed states take 68
    at N = 16; the source's launch bound says 2 blocks."""
    smem = tKB.smem_bytes(dtype, n)
    assert smem <= tKB.SMEM_PER_BLOCK
    assert tKB.BLOCKS_PER_SM * (smem + 1024) <= tKB.SMEM_PER_SM
    assert smem % 16 == 0
    assert tKB.registers_per_thread() == 128
    assert tKB.stash_registers(n) <= tKB.registers_per_thread() // 2 + 4
    if n == 16:
        assert tKB.stash_registers(n) == 68
        assert smem == {torch.float32: 68096, torch.bfloat16: 62976}[dtype]
    src = tKB.SOURCE.read_text()
    assert re.search(
        r"__launch_bounds__\(THREADS, %d\)\s+scan_bwd_pipe_kernel"
        % tKB.BLOCKS_PER_SM, src)


@pytest.mark.parametrize("s", [1, 16, 37])
def test_plain_checkpoints_match_jax_scan_states(s):
    """ref.selective_scan_checkpoints: the states before steps 0, 16, 32,
    .. of the plain scan, held in f32 at 2e-5 to the final states of
    jax.lax.scan of the reference (selective_scan_chunked) over each
    prefix (the initial state first)."""
    N = 4
    x, dt, A, proj, D, h0, _, _ = bwd_np(2, s, 8, N, seed=70 + s)
    B, C = split(proj, N)
    got = tref.selective_scan_checkpoints(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, dt, A, B,
                                                              h0)),
        tKB.CK_STEPS)
    assert got.shape == (2, -(-s // 16), 8, N) and got.dtype == torch.float32
    for k in range(got.shape[1]):
        t0 = k * tKB.CK_STEPS
        if t0 == 0:
            want = h0
        else:
            _, want = jops.selective_scan_chunked(
                *(jnp.asarray(a[:, :t0]) for a in (x, dt)), jnp.asarray(A),
                *(jnp.asarray(a[:, :t0]) for a in (B, C)), jnp.asarray(D),
                jnp.asarray(h0))
        np.testing.assert_allclose(got[:, k].numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5, err_msg=str(k))


def test_function_saves_the_forwards_checkpoints(stand_ins):
    """``_SelectiveScan`` runs the forward in training mode (counted by
    mode), saves the checkpoints it wrote and hands the backward that very
    tensor, so no backward recomputes them (``forward_checkpoints`` is
    not called); a call without a gradient runs serving mode."""
    N = 4
    x, dt, A, proj, D, h0, dy, dh = (torch.from_numpy(a) for a in bwd_np(
        2, 21, 8, N, seed=5))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, proj, D, h0)]
    B, C = split(leaves[3], N)
    before = dict(tops.launches_by_mode)
    y, h = tops.selective_scan(*leaves[:3], B, C, *leaves[4:])
    torch.autograd.grad((y, h), leaves, (dy, dh))
    (_, _, ck), (_, _, ck_bwd) = stand_ins
    assert ck is not None and ck_bwd is ck
    assert tuple(ck.shape) == tKB.checkpoint_shape((2, 21, 8, N))
    assert ck.dtype == torch.float32 and ck.is_contiguous()
    want = tref.selective_scan_checkpoints(x, dt, A, *split(proj, N)[:1],
                                           h0, tKB.CK_STEPS)
    assert torch.equal(ck[..., :N], want)
    assert {m: tops.launches_by_mode[m] - before[m]
            for m in before} == {"serving": 0, "training": 1}
    with torch.no_grad():
        tops.selective_scan(x, dt, A, *split(proj, N), D, h0)
    assert stand_ins[-1][2] is None
    assert {m: tops.launches_by_mode[m] - before[m]
            for m in before} == {"serving": 1, "training": 1}


@pytest.mark.parametrize("design,kernels,sweep,match", [
    ("first", None, False, "sweep library only"),
    ("hopper", None, True, "has designs"),
    ("pipe", ("ckpt",), False, "has kernels"),
    ("pipe", (), False, "has kernels"),
    ("first", ("bwd", "dv"), True, "has kernels"),
])
def test_backward_refuses_designs_and_kernels_it_lacks(design, kernels,
                                                       sweep, match):
    """The design ("pipe": bwd, sum) and PR 24's form ("first": ckpt, bwd,
    sum; the sweep library only) are named before any tensor is looked at
    or any library loaded."""
    gen = torch.Generator().manual_seed(1)
    *args, dy, ds = checks.bwd_inputs((1, 8, 16, 4), torch.float32, gen)
    before = tKB.library.cache_info().currsize
    with pytest.raises(ValueError, match=match):
        tKB.selective_scan_bwd_cuda(*args, dy, ds, kernels=kernels,
                                    design=design, sweep=sweep)
    assert tKB.library.cache_info().currsize == before
    assert tKB.KERNELS == ("bwd", "sum") and "ckpt" not in tKB.KERNELS
    assert tKB.DESIGNS == {"pipe": tKB.KERNELS, "first": tKB.FIRST_KERNELS}


def test_training_mode_refuses_what_it_does_not_take():
    """The forward's training mode takes the serving design and contiguous
    f32 checkpoints of ``checkpoint_shape``; it refuses before a launch."""
    gen = torch.Generator().manual_seed(2)
    args = checks.inputs((1, 20, 16, 4), torch.float32, gen)
    good = torch.empty(tK.checkpoint_shape((1, 20, 16, 4)))
    before = tK.library.cache_info().currsize
    for ck, kw in ((torch.empty(1, 1, 16, 4), {}),
                   (good.double(), {}),
                   (torch.empty(1, 16, 2, 4).transpose(1, 2), {}),
                   (good, dict(design="first", sweep=True))):
        with pytest.raises(ValueError, match="training mode takes"):
            tK.selective_scan_cuda(*args, checkpoints=ck, **kw)
    assert tK.library.cache_info().currsize == before


def test_sweep_libraries_hold_the_first_design_alone():
    """PR 24's checkpoint and reverse-pass kernels are built only with
    -DSCAN_BWD_SWEEP (the sweep library); the reverse pass and the sum
    kernel are in both."""
    src = tKB.SOURCE.read_text()
    outside = re.sub(r"#ifdef SCAN_BWD_SWEEP\n.*?#endif", "",
                     re.sub(r"//[^\n]*", "", src), flags=re.S)
    assert "scan_bwd_pipe_kernel" in outside
    assert "scan_bwd_sum_kernel" in outside
    for name in ("scan_bwd_ckpt_kernel", "scan_bwd_kernel<"):
        assert name in src and name not in outside, name
    assert "#ifdef SCAN_BWD_SWEEP" in src
