"""The PyTorch port's RWKV6 on the CPU against the JAX package.

The port's plain WKV6 (the version its dispatcher takes for CPU tensors,
and the one the CUDA kernel is held against on the card) against the
reference Pallas kernel in interpret mode and the reference oracle, at
the reference kernel tests' tolerances; the one-token step; time mix and
channel mix with bridged weights, and their gradients against
``jax.vjp``; ``RWKVLM`` prefill and decode logits and state; the
dispatcher's and the build's rules.  The backward: ``wkv6_bwd_ref``
against torch autograd of the plain version and ``jax.vjp`` of the
reference's ``wkv6_chunked`` and ``wkv6_ref`` (f32 at 2e-5, a length
past one 128-step chunk, nonzero S_0 and dS_T, w down to 0), the faults
of ``checks.py`` past the limits, and ``_WKV6``'s routing with the kernel
entry points replaced by stand-ins that call ``ref.py`` (launch counts,
saved inputs, the recompute under activation checkpointing, the forward's
checkpoints saved on the "hopper" route alone); ``kernel_bwd.plan``'s
route for every view of the card's cases, the Hopper tiles' register and
shared-memory budgets, the checkpoints' layout, and the plain
checkpoints against the reference's states.  Inputs come from numpy
seeds.  The CUDA kernel itself runs only on the card
(``chip_smoke.py``, ``tests/test_torch_gpu.py``)."""
from __future__ import annotations

import hashlib
import re
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.kernels.rwkv6 import ops as jops  # noqa: E402
from repro.kernels.rwkv6.kernel import wkv6_pallas  # noqa: E402
from repro.kernels.rwkv6.ref import wkv6_ref as jax_ref  # noqa: E402
from repro.models import rwkv6 as jR  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fK  # noqa: E402
from repro_torch.kernels.rwkv6 import checks as tchecks  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as tK  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel_bwd as tKB  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as tops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as tref  # noqa: E402
from repro_torch.models import rwkv6 as tR  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402
from repro_torch.models.rwkv_lm import RWKVLM  # noqa: E402

ARCH = "rwkv6-1.6b"
# the reference kernel tests' tolerances (tests/test_kernels.py)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **tol)


def wkv_inputs(b, s, H, hd, dtype="float32", seed=0):
    """The reference kernel tests' distribution: r/k/v/u uniform(-1, 1)
    and w = sigmoid(uniform) * 0.5 + 0.45 in ``dtype``, the state
    uniform(-1, 1) in f32.  Returns (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)

    def uni(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    r, k, v = uni(b, s, H, hd), uni(b, s, H, hd), uni(b, s, H, hd)
    w = (0.5 / (1 + np.exp(-uni(b, s, H, hd))) + 0.45).astype(np.float32)
    u, s0 = uni(H, hd), uni(b, H, hd, hd)
    dts = [dtype] * 5 + ["float32"]
    return ([jnp.asarray(a).astype(JDT[d]) for a, d in zip(
                (r, k, v, w, u, s0), dts)],
            [torch.from_numpy(a).to(TDT[d]) for a, d in zip(
                (r, k, v, w, u, s0), dts)])


# ------------------------------------------------------------ the kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,H,hd,chunk", [
    (2, 40, 2, 16, 16), (1, 100, 3, 32, 32), (2, 64, 1, 64, 64),
])
def test_plain_matches_pallas_kernel(b, s, H, hd, chunk, dtype):
    """The reference's own cases, ragged s included (padded time in the
    Pallas kernel, exactly s steps here)."""
    jin, tin = wkv_inputs(b, s, H, hd, dtype)
    y1, S1 = wkv6_pallas(*jin, chunk=chunk, interpret=True)
    y, S = tops.wkv6(*tin)
    assert y.dtype == TDT[dtype] and y.shape == (b, s, H, hd)
    assert S.dtype == torch.float32 and S.shape == (b, H, hd, hd)
    close(y1, y, TOL[dtype])
    close(S1, S, STATE_TOL)
    y2, S2 = jax_ref(*jin)
    close(y2, y, TOL[dtype])
    close(S2, S, STATE_TOL)


@pytest.mark.parametrize("s", [1, 37])
def test_plain_matches_oracle_on_strided_views(s):
    """r/k/v/w as (b, s, H, hd) views of one (b, s, 4d) projection, the
    way a fused projection would hand them over; a one-step sequence
    included."""
    b, H, hd = 2, 3, 16
    d = H * hd
    rng = np.random.default_rng(7)
    fused = rng.uniform(-1, 1, (b, s, 4 * d)).astype(np.float32)
    fused[..., 3 * d:] = 0.5 / (1 + np.exp(-fused[..., 3 * d:])) + 0.45
    u = rng.uniform(-1, 1, (H, hd)).astype(np.float32)
    s0 = rng.uniform(-1, 1, (b, H, hd, hd)).astype(np.float32)
    tf = torch.from_numpy(fused)
    views = [tf[..., i * d:(i + 1) * d].view(b, s, H, hd) for i in range(4)]
    assert not views[0].is_contiguous()
    y, S = tops.wkv6(*views, torch.from_numpy(u), torch.from_numpy(s0))
    jin = [jnp.asarray(fused[..., i * d:(i + 1) * d].reshape(b, s, H, hd))
           for i in range(4)]
    y2, S2 = jax_ref(*jin, jnp.asarray(u), jnp.asarray(s0))
    close(y2, y, TOL["float32"])
    close(S2, S, TOL["float32"])


def test_step_matches_reference_step_and_scan():
    """The one-token decode step equals the reference's step and one step
    of the scan."""
    jin, tin = wkv_inputs(2, 1, 2, 16, seed=3)
    r, k, v, w, u, s0 = tin
    y, S = tops.wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    jr, jk, jv, jw, ju, js0 = jin
    y1, S1 = jops.wkv6_step(jr[:, 0], jk[:, 0], jv[:, 0], jw[:, 0], ju, js0)
    close(y1, y, TOL["float32"])
    close(S1, S, TOL["float32"])
    y2, S2 = jax_ref(*jin)
    close(y2[:, 0], y, TOL["float32"])
    close(S2, S, TOL["float32"])


# -------------------------------------------------------- the dispatcher


def test_dispatch_counts_no_cpu_launches():
    _, tin = wkv_inputs(1, 8, 1, 16)
    before = tops.launches
    tops.wkv6(*tin)
    assert tops.launches == before


def test_dispatch_rejects_bad_input():
    _, (r, k, v, w, u, s0) = wkv_inputs(1, 8, 2, 16)
    with pytest.raises(ValueError, match="one shape"):
        tops.wkv6(r, k[:, :4], v, w, u, s0)
    with pytest.raises(ValueError, match="expected u"):
        tops.wkv6(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="expected u"):
        tops.wkv6(r, k, v, w, u, s0[:, :, :8])
    with pytest.raises(ValueError, match="empty"):
        tops.wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    with pytest.raises(TypeError, match="floating"):
        tops.wkv6(r.long(), k, v, w, u, s0)
    before = tops.launches
    meta = [t.to("meta") for t in (r, k, v, w, u, s0)]
    with pytest.raises(ValueError, match="different devices"):
        tops.wkv6(*meta[:5], s0)
    with pytest.raises(ValueError, match="no wkv6 for device meta"):
        tops.wkv6(*meta)
    assert tops.launches == before


def test_cpu_grad_takes_plain_version():
    _, (r, k, v, w, u, s0) = wkv_inputs(1, 6, 1, 16)
    r.requires_grad_(True)
    y, S = tops.wkv6(r, k, v, w, u, s0)
    (y.sum() + S.sum()).backward()
    assert r.grad is not None and torch.isfinite(r.grad).all()


# ------------------------------------------------- the kernel's plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 24, 32, 64])
def test_plan_fits_the_kernel(hd, dtype):
    """The plan for every head dim the models use: an instantiated (G, C),
    a block of at most 1024 threads, G, C and CB dividing the padded head
    dim, and the G lanes of a column inside one warp."""
    groups, cols, col_blocks = tK.plan((2, 100, 4, hd), dtype)
    hdp = tK.padded_head_dim(hd)
    assert hdp == {16: 16, 24: 32, 32: 32, 64: 64}[hd]
    assert (groups, cols) in tK.TILES and col_blocks in tK.COL_BLOCKS
    assert hdp % groups == 0 and (hdp // col_blocks) % cols == 0
    assert 32 % groups == 0
    assert tK.threads(hd, (groups, cols, col_blocks)) <= 1024
    assert tK.fits(hd, (groups, cols, col_blocks))


def test_plan_at_the_main_path_shape():
    """rwkv6-1.6b's prefill shape takes the (G, C, CB) that PERF.md
    records as the fastest candidate on the card."""
    assert tK.plan((4, 1024, 32, 64), torch.bfloat16) == (8, 4, 1)
    assert tK.plan((4, 257, 32, 64), torch.bfloat16) == (8, 4, 1)


def test_every_candidate_fits_the_main_path_head_dim():
    """45 candidates, none twice, each with an instantiation at hd 64 in
    the sweep library; the one-column-a-thread grid (G x CB,
    double-buffered) is all there but G = 16, CB = 1, whose 1024
    consumers leave no room for producers; the plan and the yardstick (G
    = C = CB = 1 without the double buffer) are among them."""
    assert len(tK.CANDIDATES) == len(set(tK.CANDIDATES)) == 45
    for groups, cols, col_blocks, _ in tK.CANDIDATES:
        assert tK.fits(64, (groups, cols, col_blocks), sweep=True)
    assert {(g, cb) for g, c, cb, pipe in tK.CANDIDATES
            if c == 1 and pipe} == {(g, cb) for g in (1, 2, 4, 8, 16)
                                    for cb in tK.COL_BLOCKS} - {(16, 1)}
    assert (*tK.PLAN, True) in tK.CANDIDATES
    assert (1, 1, 1, False) in tK.CANDIDATES
    assert tK.threads(64, (16, 1, 1)) == 1024 + tK.PRODUCERS
    assert not tK.fits(64, (16, 1, 1), sweep=True)
    assert tK.fits(32, (16, 1, 1), sweep=True)


def test_serving_library_holds_the_plan_alone():
    """The serving library instantiates the plan's tile and no other; the
    sweep library every tile of ``SWEEP_TILES``; both lists are the
    source's ``WKV6_PLANS``."""
    assert tK.TILES == (tK.PLAN[:2],)
    assert tK.PLAN[:2] in tK.SWEEP_TILES
    assert tK.fits(64, tK.PLAN) and tK.fits(64, tK.PLAN, sweep=True)
    assert not tK.fits(64, (1, 1, 1)) and tK.fits(64, (1, 1, 1), sweep=True)
    src = tK.SOURCE.read_text()
    sweep, serving = re.search(
        r"#ifdef WKV6_SWEEP\n#define WKV6_PLANS\(X\)(.*?)#else\n"
        r"#define WKV6_PLANS\(X\)(.*?)#endif", src, re.S).groups()

    def tiles(text):
        return tuple((int(g), int(c))
                     for g, c in re.findall(r"X\((\d+), (\d+)\)", text))
    assert tiles(sweep) == tK.SWEEP_TILES
    assert tiles(serving) == tK.TILES


def test_sweep_library_is_its_own_build(fake_nvcc):
    """The sweep library has a name of its own beside the serving one,
    keyed by the same source, and only its build passes -DWKV6_SWEEP."""
    digest = hashlib.sha256(tK.SOURCE.read_bytes()).hexdigest()[:16]
    assert tK.library_path(sweep=True) == (
        _build.BUILD_ROOT / f"wkv6_sweep-{digest}" / "libwkv6_sweep.so")
    assert tK.build() == tK.library_path()
    assert tK.build(sweep=True) == tK.library_path(sweep=True)
    serving, sweep = fake_nvcc.read_text().splitlines()
    assert "-DWKV6_SWEEP" not in serving and "-DWKV6_SWEEP" in sweep


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_chunk_steps_fill_the_shared_memory_budget(dtype):
    """Every candidate's chunk fits its share of the budget and is as long
    as fits, up to 64 steps; the main path's plan stages 64 bf16 steps."""
    size = torch.finfo(dtype).bits // 8
    for groups, cols, col_blocks, _ in tK.CANDIDATES:
        plan = (groups, cols, col_blocks)
        ch = tK.chunk_steps(64, dtype, plan)
        step = 2 * (64 * (4 + 3 * size) + 4) + groups * 68 * 4
        assert 1 <= ch <= tK.MAX_CHUNK
        assert ch * step <= tK.SMEM_BUDGET // col_blocks
        assert ch == tK.MAX_CHUNK or (ch + 1) * step > (
            tK.SMEM_BUDGET // col_blocks)
    assert tK.chunk_steps(64, torch.bfloat16, (8, 4, 1)) == 64


def test_plan_raises_past_head_dim_64():
    with pytest.raises(ValueError, match="head dim 128"):
        tK.plan((1, 4, 1, 128), torch.float32)
    with pytest.raises(ValueError, match="head dim 65"):
        tK.padded_head_dim(65)


@pytest.mark.parametrize("sweep", [False, True], ids=["serving", "sweep"])
@pytest.mark.parametrize("plan,hd", [
    ((3, 1, 1), 64), ((4, 1, 3), 64), ((32, 1, 1), 64), ((1, 2, 1), 64),
    ((8, 8, 4), 16), ((16, 1, 1), 128)])
def test_wkv6_cuda_rejects_plans_it_has_no_kernel_for(plan, hd, sweep):
    """Before any launch (and so on CPU tensors, with no library), in
    either library: (G, C) instantiated, CB in (1, 2, 4), C dividing a
    block's columns (8 do not divide 16 / 4), at most 64 head dims."""
    r = torch.zeros((1, 2, 1, hd))
    state = torch.zeros((1, 1, hd, hd))
    with pytest.raises(ValueError, match="head dim 128|no WKV6 plan"):
        tK.wkv6_cuda(r, r, r, r, torch.zeros((1, hd)), state, plan,
                     sweep=sweep)
    assert tK.library.cache_info().currsize == 0


@pytest.mark.parametrize("plan", [(1, 1, 1), (4, 1, 1), (16, 8, 1),
                                  (8, 4, 2)])
def test_serving_library_rejects_a_sweep_plan(plan):
    """A candidate that only the sweep library instantiates raises before
    any launch when the serving library is asked for it; CB 2 needs no
    other tile, so (8, 4, 2) passes the check."""
    r = torch.zeros((1, 2, 1, 64))
    state = torch.zeros((1, 1, 64, 64))
    assert tK.fits(64, plan, sweep=True)
    if plan[:2] == tK.PLAN[:2]:
        assert tK.fits(64, plan)
        return
    with pytest.raises(ValueError, match="in the serving library"):
        tK.wkv6_cuda(r, r, r, r, torch.zeros((1, 64)), state, plan)
    assert tK.library.cache_info().currsize == 0


def test_build_is_keyed_by_source_and_lazy():
    """Each kernel's library path is ``BUILD_ROOT/<name>-<first 16 hex of
    the source's sha256>/lib<name>.so`` (flash attention's key is what it
    was before the build helper was shared); importing compiled and
    loaded nothing."""
    for mod, name in ((tK, "wkv6"), (fK, "flash_attention")):
        digest = hashlib.sha256(mod.SOURCE.read_bytes()).hexdigest()[:16]
        assert mod.library_path() == (_build.BUILD_ROOT / f"{name}-{digest}"
                                      / f"lib{name}.so")
        assert mod.library.cache_info().currsize == 0
    assert tK.SOURCE.name == "wkv6.cu" and tK.SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_backward_library_is_its_own_lazy_build():
    """K2's backward builds from ``csrc/wkv6_bwd.cu`` into a library of
    its own, keyed by that source's hash; importing loaded nothing; a
    call launches "bwd" then the forward kernel's "dv" pass; the
    checkpoint scratch holds one padded state every SUB_STEPS steps."""
    digest = hashlib.sha256(tKB.SOURCE.read_bytes()).hexdigest()[:16]
    assert tKB.SOURCE.name == "wkv6_bwd.cu" and tKB.SOURCE.exists()
    assert _build.library_path(tKB.SOURCE, tKB.NAME) == (
        _build.BUILD_ROOT / f"wkv6_bwd-{digest}" / "libwkv6_bwd.so")
    assert tKB.library.cache_info().currsize == 0
    assert tKB.KERNELS == ("bwd", "dv")
    assert tKB.checkpoint_shape((4, 2048, 32, 64)) == (4, 32, 128, 64, 64)
    assert tKB.checkpoint_shape((2, 17, 3, 24)) == (2, 3, 2, 32, 32)


def test_backward_rejects_what_its_kernels_do_not_take():
    """wkv6_bwd_cuda checks before any build or launch: CPU tensors, a
    head dim past 64, mixed dtypes, a bf16 w or a non-contiguous state
    raise ValueError."""
    _, (r, k, v, w, u, s0) = wkv_inputs(1, 5, 2, 16)
    dy = torch.ones_like(r)
    with pytest.raises(ValueError, match="wkv6_bwd takes"):
        tKB.wkv6_bwd_cuda(r, k, v, w, u, s0, dy)
    meta = [t.to("meta") for t in (r, k, v, w, u, s0, dy)]
    for bad in (
            [meta[0].bfloat16(), *meta[1:]],
            [*meta[:3], meta[3].bfloat16(), *meta[4:]],
            [*meta[:5], meta[5].transpose(2, 3), meta[6]]):
        with pytest.raises(ValueError, match="wkv6_bwd takes"):
            tKB.wkv6_bwd_cuda(*bad)
    big = torch.empty((1, 4, 1, 128), device="meta")
    with pytest.raises(ValueError, match="hd <= 64"):
        tKB.wkv6_bwd_cuda(big, big, big, big, torch.empty((1, 128)),
                          torch.empty((1, 1, 128, 128)), big)
    assert tKB.library.cache_info().currsize == 0


FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: logs its call and writes the file after -o
echo "$@" >> "{log}"
args="$*"
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo lib > "$2"; fi
  shift
done
case "$args" in *broken*) echo "error: broken source" >&2; exit 2;; esac
echo "ptxas info    : Used 40 registers"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc under CUDA_HOME, a build root in tmp_path."""
    log = tmp_path / "calls.log"
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", "/usr/bin:/bin")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    return log


def test_build_helper_builds_each_source_once(fake_nvcc, tmp_path):
    src = tmp_path / "one.cu"
    src.write_text("// one\n")
    so = _build.build(src, "one")
    assert so == _build.library_path(src, "one") and so.exists()
    assert so.name == "libone.so"
    assert "registers" in (so.parent / "build.log").read_text()
    assert len(fake_nvcc.read_text().splitlines()) == 1
    assert _build.build(src, "one") == so        # cached: nvcc not run
    assert len(fake_nvcc.read_text().splitlines()) == 1
    src.write_text("// one, edited\n")
    assert _build.build(src, "one") != so        # new hash, new build
    assert len(fake_nvcc.read_text().splitlines()) == 2


def test_build_helper_raises_on_a_failed_build(fake_nvcc, tmp_path):
    bad = tmp_path / "broken.cu"
    bad.write_text("// bad\n")
    with pytest.raises(RuntimeError, match="nvcc failed for broken-"):
        _build.build(bad, "broken")
    failed = _build.library_path(bad, "broken")
    assert not failed.exists()
    assert [p.name for p in failed.parent.iterdir()] == ["build.log"]
    assert "broken source" in (failed.parent / "build.log").read_text()


# -------------------------------------------------------------- the model


def perturbed_params(params, seed):
    """The reference init leaves the token-shift mixes at 0 and the scales
    at 1, which would leave their paths unchecked: add noise to them, the
    decay bias and u, identically for both packages."""
    rng = np.random.default_rng(seed)
    noisy = {"mu_x": 0.5, "mu": 0.5, "mu_k": 0.5, "mu_r": 0.5, "w0": 0.5,
             "u": 0.5, "ln_scale": 0.2, "scale": 0.2}

    def fn(path, leaf):
        scale = noisy.get(path[-1].key)
        if scale is None:
            return leaf
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * scale
        return (leaf.astype(jnp.float32) + noise).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fn, params)


def bridged(tree):
    return params_from_flat({k: np.asarray(v) for k, v in _flatten(tree)})


def test_time_mix_and_channel_mix_match_reference():
    cfg = get_smoke(ARCH).replace(dtype="float32")
    tcfg = torch_smoke(ARCH).replace(dtype="float32")
    rng = jax.random.split(jax.random.PRNGKey(4), 2)
    jtm = perturbed_params(jR.init_time_mix(rng[0], cfg, jnp.float32), 5)
    jcm = perturbed_params(jR.init_channel_mix(rng[1], cfg, jnp.float32), 6)
    ttm, tcm = bridged(jtm), bridged(jcm)
    b, d, hd = 2, cfg.d_model, cfg.rwkv.head_dim
    H = d // hd
    g = np.random.default_rng(8)
    state = g.standard_normal((b, H, hd, hd)).astype(np.float32)
    last = g.standard_normal((b, d)).astype(np.float32)
    for s in (9, 1):        # the kernel's path, then the one-step path
        x = g.standard_normal((b, s, d)).astype(np.float32)
        jy, (jS, jlast) = jR.time_mix(jnp.asarray(x), jtm, cfg,
                                      jnp.asarray(state), jnp.asarray(last))
        ty, (tS, tlast) = tR.time_mix(torch.from_numpy(x), ttm, tcfg,
                                      torch.from_numpy(state),
                                      torch.from_numpy(last))
        close(jy, ty, TOL["float32"])
        close(jS, tS, TOL["float32"])
        close(jlast, tlast, TOL["float32"])
        jc, jcl = jR.channel_mix(jnp.asarray(x), jcm, jnp.asarray(last))
        tc, tcl = tR.channel_mix(torch.from_numpy(x), tcm,
                                 torch.from_numpy(last))
        close(jc, tc, TOL["float32"])
        close(jcl, tcl, TOL["float32"])


def test_init_shapes_and_dtypes_match_reference():
    """Seeded initialisers: the same names, shapes and dtypes as the
    reference's, and the state layout of ``init_state``/``init_cache``."""
    cfg = get_smoke(ARCH)
    jm = jax_build(cfg)
    jflat = {k: v for k, v in _flatten(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0)))}
    tm = torch_build(torch_smoke(ARCH))
    assert isinstance(tm, RWKVLM)
    tflat = {k: v for k, v in _flatten_torch(
        tm.init(torch.Generator().manual_seed(0), "cpu"))}
    assert sorted(jflat) == sorted(tflat)
    for key, leaf in jflat.items():
        assert tuple(leaf.shape) == tuple(tflat[key].shape), key
        assert str(leaf.dtype) == str(tflat[key].dtype)[6:], key
    jstate = jR.init_state(cfg, 3, jnp.bfloat16)
    tstate = tR.init_state(torch_smoke(ARCH), 3, torch.bfloat16)
    jcache = jm.init_cache(3, 0)
    tcache = tm.init_cache(3, 0, "cpu")
    for j, t in ((jstate, tstate), (jcache, tcache)):
        for key in ("wkv", "tm_x", "cm_x"):
            assert tuple(j[key].shape) == tuple(t[key].shape), key
            assert str(j[key].dtype) == str(t[key].dtype)[6:], key


def _flatten_torch(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten_torch(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def model_pair(dtype="float32", seed=0):
    jm = jax_build(get_smoke(ARCH).replace(dtype=dtype))
    jp = perturbed_params(jm.init(jax.random.PRNGKey(seed)), seed + 10)
    tm = torch_build(torch_smoke(ARCH).replace(dtype=dtype))
    return jm, jp, tm, bridged(jp)


def test_prefill_decode_match_reference():
    """Logits and the whole state after prefill and after each of three
    decode steps, f32 at 2e-5."""
    jm, jp, tm, tp = model_pair()
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jcache, jlen = jax.jit(lambda p, t: jm.prefill(p, t, 0))(
        jp, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 0)
    assert tl.shape == (2, 1, jm.cfg.vocab_size) and tlen == int(jlen) == 20
    close(jl, tl, TOL["float32"])
    for key in ("wkv", "tm_x", "cm_x"):
        close(jcache[key], tcache[key], TOL["float32"])
    step = jax.jit(jm.decode)
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for _ in range(3):
        jl, jcache, jlen = step(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            wkv = tcache["wkv"]
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
            assert tcache["wkv"] is wkv          # updated in place
        assert tlen == int(jlen)
        close(jl, tl, TOL["float32"])
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for key in ("wkv", "tm_x", "cm_x"):
        close(jcache[key], tcache[key], TOL["float32"])


def test_one_token_prompt_takes_the_step_path():
    """s == 1 in prefill takes the step path, as in the reference."""
    jm, jp, tm, tp = model_pair(seed=2)
    toks = np.array([[5], [9]], np.int32)
    jl, jcache, _ = jm.prefill(jp, jnp.asarray(toks), 0)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 0)
    assert tlen == 1
    close(jl, tl, TOL["float32"])
    close(jcache["wkv"], tcache["wkv"], TOL["float32"])


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2),
                                       ("float32", 2e-5)])
def test_decode_matches_prefill_rwkv(dtype, tol):
    """Torch mirror of the reference's check: recurrent-state decode
    matches the parallel form (prefill 11, decode 1 against prefill 12;
    bf16 at the reference's 2e-2)."""
    tm = torch_build(torch_smoke(ARCH).replace(dtype=dtype))
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (1, 12)))
    with torch.inference_mode():
        ref, _, _ = tm.prefill(tp, toks, 0)
        _, cache, length = tm.prefill(tp, toks[:, :11], 0)
        logits, _, length = tm.decode(tp, cache, toks[:, 11:12], length)
    assert length == 12
    torch.testing.assert_close(logits[:, 0].float(), ref[:, 0].float(),
                               rtol=tol, atol=tol)


def test_bf16_prefill_matches_reference():
    jm, jp, tm, tp = model_pair("bfloat16", seed=3)
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _, _ = jm.prefill(jp, jnp.asarray(toks), 0)
    with torch.inference_mode():
        tl, _, _ = tm.prefill(tp, torch.from_numpy(toks), 0)
    assert tl.dtype == torch.bfloat16
    close(jl, tl, TOL["bfloat16"])


# ------------------------------------------------------------ the backward


def bwd_np(b, s, H, hd, seed, fast_decay):
    """numpy f32 inputs for the backward: r/k/v/u/dy uniform(-1, 1), S_0
    and dS_T uniform(-1, 1); w as ``wkv_inputs`` (0.45-0.95), or with
    ``fast_decay`` exp(-exp(1 + 2 N(0, 1))), from about 1 down to exactly
    0 in f32."""
    rng = np.random.default_rng(seed)

    def uni(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    r, k, v, dy = (uni(b, s, H, hd) for _ in range(4))
    if fast_decay:
        w = np.exp(-np.exp(1 + 2 * rng.standard_normal((b, s, H, hd))))
        w = w.astype(np.float32)
        assert (w == 0).any() and (w > 0.5).any()
    else:
        w = (0.5 / (1 + np.exp(-uni(b, s, H, hd))) + 0.45).astype(np.float32)
    return r, k, v, w, uni(H, hd), uni(b, H, hd, hd), dy, uni(b, H, hd, hd)


def close_grads(want, got, tol=2e-5):
    """Each gradient within ``tol`` relative and ``tol`` of its largest
    |value| (G sums up to s rank-1 terms: an elementwise limit at the
    smallest entries would hold rounding to a bare 2e-5)."""
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), want, got):
        a = np.asarray(a, np.float32)
        b = b.detach().float().numpy()
        assert np.isfinite(b).all(), name
        np.testing.assert_allclose(b, a, rtol=tol,
                                   atol=tol * np.abs(a).max(), err_msg=name)


BWD_CASES = [(6, False), (130, False), (6, True), (130, True)]
BWD_IDS = ["s6", "s130", "s6-w-to-0", "s130-w-to-0"]


@pytest.mark.parametrize("s,fast", BWD_CASES, ids=BWD_IDS)
def test_bwd_ref_matches_autograd(s, fast):
    """wkv6_bwd_ref against torch autograd of wkv6_ref, with nonzero S_0
    and dS_T, f32 at 2e-5."""
    arrays = bwd_np(2, s, 3, 16, seed=20 + s, fast_decay=fast)
    r, k, v, w, u, s0, dy, ds = (torch.from_numpy(a) for a in arrays)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    y, S = tR.wkv_ops.wkv6_ref(*leaves)
    want = torch.autograd.grad((y, S), leaves, (dy, ds))
    got = tref.wkv6_bwd_ref(r, k, v, w, u, s0, dy, ds)
    close_grads([g.numpy() for g in want], got)


@pytest.mark.parametrize("oracle", ["wkv6_chunked", "wkv6_ref"])
@pytest.mark.parametrize("s,fast", BWD_CASES, ids=BWD_IDS)
def test_bwd_ref_matches_jax_vjp(s, fast, oracle):
    """wkv6_bwd_ref against jax.vjp of the reference's chunked twin (the
    one it trains through: s = 130 pads to two 128-step chunks with w = 1)
    and of its step scan, with nonzero S_0 and dS_T and w down to 0, f32
    at 2e-5; every gradient finite."""
    arrays = bwd_np(2, s, 3, 16, seed=40 + s, fast_decay=fast)
    fn = jops.wkv6_chunked if oracle == "wkv6_chunked" else jax_ref
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays[:6]))
    want = vjp((jnp.asarray(arrays[6]), jnp.asarray(arrays[7])))
    got = tref.wkv6_bwd_ref(*(torch.from_numpy(a) for a in arrays))
    close_grads(want, got)


@pytest.mark.parametrize("fault", tchecks.BWD_FAULTS)
def test_bwd_faults_fail_the_limits(fault):
    """Each fault of checks.py lands past its gradient's f32 limit by more
    than 10x (the u term of dk where the states forget fast, as
    chip_smoke.py shows it), while the plain backward's own gradients
    rounded to bf16 stay within the bf16 limits."""
    gen = torch.Generator().manual_seed(5)
    ins = tchecks.bwd_inputs((2, 96, 2, 32), torch.float32, gen,
                             state_scale=10.0, dstate_scale=1.0,
                             fast_decay=fault == "no-u-in-dk")
    ref = tref.wkv6_bwd_ref(*ins)
    scales = tchecks.bwd_row_scales(*ins)
    bad = tchecks.wkv6_bwd_faulty(*ins, fault)
    errs = tchecks.bwd_errors(bad, ref, scales)
    limits = tchecks.BWD_ROW_TOL[torch.float32]
    assert not tchecks.bwd_within(errs, torch.float32)
    assert max(e / limits[g] for g, e in errs.items()) > 10, errs
    rounded = [g.to(torch.bfloat16) if i < 3 else g
               for i, g in enumerate(ref)]
    assert tchecks.bwd_within(tchecks.bwd_errors(rounded, ref, scales),
                              torch.bfloat16)
    with pytest.raises(ValueError, match="no fault"):
        tchecks.wkv6_bwd_faulty(*ins, "no-such-fault")


@pytest.fixture
def stand_ins(monkeypatch):
    """The kernel entry points replaced by CPU stand-ins that call
    ref.py, and ops.wkv6's CPU tensors routed through ``_WKV6`` as CUDA
    tensors are: this tests the routing, not the kernels.  Returns the
    record of the stand-ins' calls, in order."""
    calls = []
    ref_fwd, ref_bwd = tref.wkv6_ref, tref.wkv6_bwd_ref

    def forward(r, k, v, w, u, state, plan, pipelined=True, sweep=False,
                checkpoints=None, ck_steps=0):
        calls.append(("fwd", (r, k, v, w, u, state),
                      dict(checkpoints=checkpoints, ck_steps=ck_steps)))
        if checkpoints is not None:
            checkpoints.copy_(tref.wkv6_checkpoints(k, v, w, state, ck_steps))
        return ref_fwd(r, k, v, w, u, state)

    def backward(r, k, v, w, u, state, dy, dstate=None, **kw):
        calls.append(("bwd", (r, k, v, w, u, state, dy, dstate), kw))
        g = ref_bwd(r, k, v, w, u, state, dy, dstate)
        return (*(x.to(r.dtype) for x in g[:3]), *g[3:])

    def routed(r, k, v, w, u, state):
        uf = u.float()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, w, uf, state)):
            return tops._WKV6.apply(r, k, v, w, uf, state)
        return tops._forward(r, k, v, w, uf, state)

    monkeypatch.setattr(tK, "wkv6_cuda", forward)
    monkeypatch.setattr(tKB, "wkv6_bwd_cuda", backward)
    monkeypatch.setattr(tops, "wkv6", routed)
    return calls


@pytest.mark.parametrize("with_state_grad", [False, True])
def test_function_launches_and_saves_its_inputs(stand_ins, with_state_grad):
    """``_WKV6``: one forward launch, the backward's kernels counted once,
    the backward handed the very tensors the forward saved (views as
    they are, u in f32) and dS_T only where the final state is used; its
    gradients are autograd's of wkv6_ref, u's cast back through
    u.float()."""
    arrays = bwd_np(2, 9, 2, 16, seed=3, fast_decay=False)
    r, k, v, w, u, s0, dy, ds = (torch.from_numpy(a) for a in arrays)
    fused = torch.cat([r, k], dim=-1)
    r, k = fused[..., :16], fused[..., 16:]              # strided views
    ub = u.bfloat16()
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, ub, s0)]
    before = (tops.launches, tops.launches_bwd)
    y, S = tops.wkv6(*leaves)
    outs, grads = ((y, S), (dy, ds)) if with_state_grad else ((y,), (dy,))
    got = torch.autograd.grad(outs, leaves, grads)
    assert (tops.launches - before[0], tops.launches_bwd - before[1]) == (
        1, len(tKB.KERNELS))
    assert [c[0] for c in stand_ins] == ["fwd", "bwd"]
    fwd_args, bwd_args = stand_ins[0][1], stand_ins[1][1]
    for a, b in zip(fwd_args, bwd_args[:6]):
        assert a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
    assert bwd_args[4].dtype == torch.float32
    assert (bwd_args[7] is None) != with_state_grad
    ref_leaves = [t.clone().requires_grad_() for t in (r, k, v, w, ub, s0)]
    y2, S2 = tref.wkv6_ref(*ref_leaves)
    want = torch.autograd.grad((y2, S2) if with_state_grad else (y2,),
                               ref_leaves, grads)
    assert got[4].dtype == torch.bfloat16
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=2e-5, atol=2e-5)


def test_remat_recomputes_the_saved_inputs(stand_ins):
    """RWKVLM.loss with each layer under activation checkpointing: the
    forward launches twice a layer (the forward, then its recompute in
    the backward), each backward is handed the inputs its layer's
    recompute saved, and loss and gradients equal those without remat,
    bit for bit."""
    from repro_torch import tree as T
    from repro_torch.models import common as C
    from repro_torch.training.step import value_and_grad
    jm, jp, tm, tp = model_pair(seed=4)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tm.cfg.vocab_size, (2, 21)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n = tm.cfg.n_layers

    class NoRemat(RWKVLM):
        def loss(self, params, batch):
            x = self._embed(params, batch["tokens"])
            cache = self.init_cache(x.shape[0], 0, x.device)
            layers = C.unstack_layers(params["layers"], self.cfg.n_layers)
            for l, lp in enumerate(layers):
                x = self._train_layer(x, lp, C.index_layer(cache, l))
            x = tR.L.apply_norm(x, params["final_norm"], self.cfg)
            logits = C.lm_logits(x, params["embed"], self.cfg)
            xent = tR.L.softmax_xent(logits, batch["labels"])
            return xent, {"xent": xent}

    loss0, _, grads0 = value_and_grad(NoRemat(tm.cfg), tp, batch)
    stand_ins.clear()
    loss, _, grads = value_and_grad(tm, tp, batch)
    kinds = [c[0] for c in stand_ins]
    assert kinds == ["fwd"] * n + ["fwd", "bwd"] * n
    for l in range(n):
        recompute = stand_ins[n + 2 * l][1]
        handed = stand_ins[n + 2 * l + 1][1]
        for a, b in zip(recompute, handed[:6]):
            assert a.data_ptr() == b.data_ptr()
    assert torch.equal(loss, loss0)
    for (path, g), g0 in zip(T.flatten(grads), T.leaves(grads0)):
        assert torch.equal(g, g0), path


# ------------------------------------------- the backward's two routes


def _views(shape, dtype, strided, offset=0):
    """r, k, v, w (uninitialised) as ``checks.inputs`` lays them out: each
    its own (b, s, H, hd) tensor, or with ``strided`` views of one (b, s,
    3d) tensor (w of a (b, s, 2d) one); ``offset`` elements into their
    storage."""
    b, s, h, hd = shape
    d = h * hd
    if strided:
        rkv = torch.empty(b * s * 3 * d + offset, dtype=dtype)[offset:]
        rkv = rkv.view(b, s, 3 * d)
        r, k, v = (rkv[..., i * d:(i + 1) * d].view(b, s, h, hd)
                   for i in range(3))
        w = torch.empty(b * s * 2 * d + offset)[offset:].view(b, s, 2 * d)
        return r, k, v, w[..., :d].view(b, s, h, hd)
    r, k, v = (torch.empty(b * s * d + offset, dtype=dtype)[offset:]
               .view(shape) for _ in range(3))
    return r, k, v, torch.empty(b * s * d + offset)[offset:].view(shape)


# chip_smoke.py's WKV_BWD_CASES (name, shape, dtype, strided) and the route
# each takes: "hopper" at hd 64, strided views of fused storages included
# (their strides are multiples of 16 bytes); "general" below
BWD_ROUTE_CASES = [
    ("training", (4, 2048, 32, 64), torch.bfloat16, False, "hopper"),
    ("training-f32", (4, 2048, 32, 64), torch.float32, False, "hopper"),
    ("strided", (2, 1024, 32, 64), torch.bfloat16, True, "hopper"),
    ("states", (2, 1024, 16, 64), torch.float32, False, "hopper"),
    ("s1000", (2, 1000, 32, 64), torch.bfloat16, False, "hopper"),
    ("s2047-strided-f32", (1, 2047, 8, 64), torch.float32, True, "hopper"),
    ("small-w", (2, 1024, 16, 64), torch.float32, False, "hopper"),
    ("small-w-bf16", (2, 1024, 16, 64), torch.bfloat16, False, "hopper"),
    ("hd16-s37-strided", (2, 37, 4, 16), torch.float32, True, "general"),
    ("hd24-s100", (2, 100, 4, 24), torch.float32, False, "general"),
]


@pytest.mark.parametrize("name,shape,dtype,strided,route", BWD_ROUTE_CASES,
                         ids=[c[0] for c in BWD_ROUTE_CASES])
def test_bwd_plan_routes_each_case(name, shape, dtype, strided, route):
    """``kernel_bwd.plan`` on the views of each of chip_smoke.py's backward
    cases gives the route pinned here (the training shape, contiguous
    bf16 and f32, on "hopper")."""
    assert tKB.plan(*_views(shape, dtype, strided)) == route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bwd_plan_routes_what_tma_cannot_read_to_general(dtype):
    """At hd 64: a view one element into its storage (a base address off
    16 bytes), a bf16 w, an odd head stride and a head dim of 32 all take
    "general"; the same views at offset 0 take "hopper"."""
    shape = (2, 40, 3, 64)
    assert tKB.plan(*_views(shape, dtype, False)) == "hopper"
    assert tKB.plan(*_views(shape, dtype, True)) == "hopper"
    assert tKB.plan(*_views(shape, dtype, False, offset=1)) == "general"
    assert tKB.plan(*_views(shape, dtype, True, offset=1)) == "general"
    r, k, v, w = _views(shape, dtype, False)
    assert tKB.plan(r, k, v, w.bfloat16()) == "general"
    odd = torch.empty((2, 40, 3, 66), dtype=dtype)[..., :64]
    assert tKB.plan(odd, k, v, w) == "general"
    assert tKB.plan(*_views((2, 40, 3, 32), dtype, False)) == "general"


def test_every_bwd_tile_fits_its_budgets():
    """Every Hopper tile (R, C, SUB) of the sweep library: R divides 64, C
    a multiple of 4 dividing 64, a block of at most 1024 threads whose
    consumers are whole warps and a multiple of 64; its shared memory
    (both dtypes) within a block's 227 KB; its stash and working set
    within the registers one block an SM leaves a thread.  PLAN is one of
    them and the serving library's only one; both lists are the source's
    ``WKV6_BWD_TILES``."""
    assert tKB.PLAN in tKB.SWEEP_TILES and tKB.TILES == (tKB.PLAN,)
    assert len(set(tKB.SWEEP_TILES)) == len(tKB.SWEEP_TILES)
    for tile in tKB.SWEEP_TILES:
        rows, cols, sub = tile
        assert 64 % rows == 0 and cols % 4 == 0 and 64 % cols == 0
        consumers = tKB.threads(tile) - tKB.PRODUCER
        assert consumers % 64 == 0 and consumers % 32 == 0
        assert tKB.threads(tile) <= 1024
        for dtype in (torch.float32, torch.bfloat16):
            size, sets = tKB.shared_memory(tile, dtype)
            assert size <= tKB.SMEM_MAX and sets in (1, 2)
        assert sub * rows * cols <= tKB.registers_needed(tile)
        assert tKB.registers_needed(tile) <= tKB.register_budget(tile), tile
    src = tKB.SOURCE.read_text()
    sweep, serving = re.search(
        r"#ifdef WKV6_BWD_SWEEP\n#define WKV6_BWD_TILES\(X\)(.*?)#else\n"
        r"#define WKV6_BWD_TILES\(X\)(.*?)#endif", src, re.S).groups()

    def tiles(text):
        return tuple(tuple(int(x) for x in t) for t in
                     re.findall(r"X\((\d+), (\d+), (\d+)\)", text))
    assert tiles(sweep) == tKB.SWEEP_TILES
    assert tiles(serving) == tKB.TILES


def test_checkpoint_layout_undone_and_free_of_bank_conflicts():
    """``checkpoint_states`` undoes the forward's chunk permutation (the
    sources' ``ck_swizzle``, the same in both); the 8 rows that 8 lanes
    of a Hopper tile read together, {l R + e}, land on 8 different 16-byte
    bank groups for R in 1, 2, 4."""
    expr = "return (row & 7) ^ ((row >> 3) & 3);"
    assert expr in tKB.SOURCE.read_text() and expr in tK.SOURCE.read_text()
    plain = torch.arange(2 * 3 * 64 * 64, dtype=torch.float32).view(
        2, 1, 3, 64, 64)
    stored = torch.empty_like(plain)
    for i in range(64):
        for q in range(16):
            p = q ^ tKB.ck_swizzle(i)
            stored[..., i, 4 * p:4 * p + 4] = plain[..., i, 4 * q:4 * q + 4]
    assert torch.equal(tKB.checkpoint_states(stored), plain)
    for rows in (1, 2, 4):
        for first in range(0, 64 // rows, 8):
            for e in range(rows):
                for q in range(16):
                    banks = {(q ^ tKB.ck_swizzle((first + lane) * rows + e))
                             % 8 for lane in range(8)}
                    assert len(banks) == 8, (rows, first, e, q)


@pytest.mark.parametrize("steps", [8, 16])
def test_plain_checkpoints_match_reference_states(steps):
    """``ref.wkv6_checkpoints``: S_0, then the state after every ``steps``
    steps, against the final state of the reference's ``wkv6_ref`` run
    over the same prefix, f32 at 2e-5, with w down to 0 and a ragged end
    (s = 37)."""
    arrays = bwd_np(2, 37, 3, 16, seed=60 + steps, fast_decay=True)
    r, k, v, w, u, s0 = arrays[:6]
    got = tref.wkv6_checkpoints(*(torch.from_numpy(a)
                                  for a in (k, v, w, s0)), steps)
    assert got.shape == (2, 3, -(-37 // steps), 16, 16)
    np.testing.assert_array_equal(got[:, :, 0].numpy(), s0)
    for c in range(1, got.shape[2]):
        t = c * steps
        _, want = jax_ref(*(jnp.asarray(a[:, :t]) for a in (r, k, v, w)),
                          jnp.asarray(u), jnp.asarray(s0))
        np.testing.assert_allclose(got[:, :, c].numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_training_mode_forward_rejects_what_it_has_no_kernel_for():
    """``kernel.wkv6_cuda`` with checkpoints raises before any launch for
    a head dim other than 64, a buffer of another shape or dtype, or no
    steps; a chunk in training mode is a multiple of the steps."""
    r = torch.zeros((1, 20, 1, 64))
    state = torch.zeros((1, 1, 64, 64))
    ck = torch.zeros(tKB.checkpoint_shape(r.shape, 8))
    for bad in (dict(checkpoints=ck[:, :, :1], ck_steps=8),
                dict(checkpoints=ck.double(), ck_steps=8),
                dict(checkpoints=ck, ck_steps=0),
                dict(checkpoints=ck, ck_steps=8, pipelined=False)):
        with pytest.raises(ValueError, match="training mode takes"):
            tK.wkv6_cuda(r, r, r, r, torch.zeros((1, 64)), state, tK.PLAN,
                         **bad)
    small = torch.zeros((1, 20, 1, 16))
    with pytest.raises(ValueError, match="training mode takes"):
        tK.wkv6_cuda(small, small, small, small, torch.zeros((1, 16)),
                     torch.zeros((1, 1, 16, 16)), tK.PLAN,
                     checkpoints=torch.zeros(tKB.checkpoint_shape(
                         small.shape, 8)), ck_steps=8)
    assert tK.library.cache_info().currsize == 0
    for dtype in (torch.float32, torch.bfloat16):
        for steps in (4, 8, 16):
            ch = tK.chunk_steps(64, dtype, tK.PLAN, steps)
            assert ch % steps == 0 and 0 < ch <= tK.chunk_steps(
                64, dtype, tK.PLAN)


@pytest.mark.parametrize("hd,route", [(64, "hopper"), (16, "general")])
def test_function_saves_checkpoints_only_on_the_hopper_route(stand_ins, hd,
                                                             route):
    """``_WKV6`` picks the route before the forward: on "hopper" the
    forward runs in training mode into a (b, H, ceil(s / PLAN[2]), 64, 64)
    f32 buffer, every PLAN[2] steps, and the backward is handed that very
    buffer; on "general" the forward runs in serving mode and the
    backward gets no buffer.  The backward's launches are counted by
    route; the gradients are autograd's of wkv6_ref."""
    arrays = bwd_np(1, 20, 2, hd, seed=7, fast_decay=False)
    r, k, v, w, u, s0, dy, ds = (torch.from_numpy(a) for a in arrays)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    before = dict(tops.launches_bwd_by_route)
    y, S = tops.wkv6(*leaves)
    got = torch.autograd.grad((y, S), leaves, (dy, ds))
    (_, _, fkw), (_, _, bkw) = stand_ins
    assert bkw["route"] == route
    steps = tKB.PLAN[2]
    if route == "hopper":
        ck = fkw["checkpoints"]
        assert fkw["ck_steps"] == steps
        assert ck.shape == tKB.checkpoint_shape(r.shape, steps)
        assert ck.dtype == torch.float32
        assert bkw["checkpoints"] is ck
    else:
        assert fkw["checkpoints"] is None and bkw["checkpoints"] is None
    assert {rt: n - before[rt] for rt, n in
            tops.launches_bwd_by_route.items()} == {
        rt: len(tKB.KERNELS) if rt == route else 0 for rt in tKB.ROUTES}
    ref_leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    want = torch.autograd.grad(tref.wkv6_ref(*ref_leaves), ref_leaves,
                               (dy, ds))
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=2e-5, atol=2e-5)


def test_time_mix_and_channel_mix_grads_match_reference():
    """The time mix's and channel mix's gradients (through the token
    shift, the LoRA mixes, the decay chain exp(-exp(w0 + dw)) in f32, the
    WKV recurrence and the group norm: population variance, eps 64e-5)
    against jax.vjp of the reference's, for every input, param and the
    carried states, f32 at 1e-4 of each leaf's largest |g|."""
    cfg = get_smoke(ARCH).replace(dtype="float32")
    tcfg = torch_smoke(ARCH).replace(dtype="float32")
    rng = jax.random.split(jax.random.PRNGKey(7), 2)
    jtm = perturbed_params(jR.init_time_mix(rng[0], cfg, jnp.float32), 8)
    jcm = perturbed_params(jR.init_channel_mix(rng[1], cfg, jnp.float32), 9)
    b, s, d, hd = 2, 9, cfg.d_model, cfg.rwkv.head_dim
    H = d // hd
    g = np.random.default_rng(10)
    x, state, last, gy, gS, gl = (
        g.standard_normal(shape).astype(np.float32)
        for shape in ((b, s, d), (b, H, hd, hd), (b, d), (b, s, d),
                      (b, H, hd, hd), (b, d)))

    def jtime(p, x, state, last):
        return jR.time_mix(x, p, cfg, state, last)

    _, vjp = jax.vjp(jtime, jtm, jnp.asarray(x), jnp.asarray(state),
                     jnp.asarray(last))
    jg = vjp((jnp.asarray(gy), (jnp.asarray(gS), jnp.asarray(gl))))
    tp = {k: v.requires_grad_() for k, v in bridged(jtm).items()}
    tx, ts, tl = (torch.from_numpy(a).requires_grad_()
                  for a in (x, state, last))
    ty, (tS, tlast) = tR.time_mix(tx, tp, tcfg, ts, tl)
    tg = torch.autograd.grad(
        (ty, tS, tlast), [*tp.values(), tx, ts, tl],
        (torch.from_numpy(gy), torch.from_numpy(gS), torch.from_numpy(gl)))
    want = [np.asarray(jg[0][key]) for key in tp] + [np.asarray(a)
                                                    for a in jg[1:]]
    for name, a, t in zip([*tp, "x", "state", "last_x"], want, tg):
        np.testing.assert_allclose(t.numpy(), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(), err_msg=name)
    _, vjp = jax.vjp(lambda p, x, last: jR.channel_mix(x, p, last), jcm,
                     jnp.asarray(x), jnp.asarray(last))
    jg = vjp((jnp.asarray(gy), jnp.asarray(gl)))
    tp = {k: v.requires_grad_() for k, v in bridged(jcm).items()}
    tx, tl = (torch.from_numpy(a).requires_grad_() for a in (x, last))
    tc, tcl = tR.channel_mix(tx, tp, tl)
    tg = torch.autograd.grad((tc, tcl), [*tp.values(), tx, tl],
                             (torch.from_numpy(gy), torch.from_numpy(gl)))
    want = [np.asarray(jg[0][key]) for key in tp] + [np.asarray(a)
                                                    for a in jg[1:]]
    for name, a, t in zip([*tp, "x", "last_x"], want, tg):
        np.testing.assert_allclose(t.numpy(), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(), err_msg=name)
