"""The port on the card: the CUDA flash attention (K1), WKV6 (K2) and
selective scan (K3) kernels against their plain versions, the
dispatchers' rules for CUDA tensors, and DecoderLM, RWKVLM and JambaLM
prefill through the kernels against the same models on the CPU.

Every test here needs an NVIDIA GPU and skips without one.  On a machine
with a card, from the repository root:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it also runs where JAX is not installed.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import checks as scan_checks  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import checks  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_ref  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402

pytestmark = pytest.mark.gpu

# Elementwise (atol = rtol) and per-row ||out - ref|| / ||ref|| limits.
# bf16: both sides round the output to bf16 (one ulp is 0.008-0.03 at
# |out| ~ 1-4) and the kernel rounds P to bf16 (relative 2^-9).
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on one, run: python -m pytest -q "
                    "-m gpu tests/test_torch_gpu.py")
    # f32 products in full f32 on the plain side of every comparison
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _qkv(b, sq, skv, h, hd, dtype, strided=False, seed=0):
    """q, k ~ N(0, 4), v ~ N(0, 1): each row's softmax peaks on a few
    keys, so |out| is O(1) in every row and a lost or doubled kv tile
    moves the rows that attend into it by O(1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(s, scale):
        if strided:       # (b, h, s, hd) storage seen as (b, s, h, hd)
            x = torch.randn((b, h, s, hd), generator=gen, device="cuda")
            x = x.transpose(1, 2)
        else:
            x = torch.randn((b, s, h, hd), generator=gen, device="cuda")
        return (x * scale).to(dtype)

    return randn(sq, 2.0), randn(skv, 2.0), randn(skv, 1.0)


# (b, sq, skv, h, hd), causal, window, softcap, strided; each in f32 and
# in bf16
CASES = [
    ((2, 100, 100, 6, 12), True, 0, 0.0, False),
    ((2, 130, 130, 4, 16), True, 16, 0.0, True),
    ((1, 257, 257, 4, 64), True, 64, 0.0, False),
    ((1, 64, 192, 2, 64), False, 0, 0.0, False),
    ((2, 200, 200, 4, 128), True, 0, 0.0, False),
    ((1, 96, 96, 2, 256), True, 0, 30.0, False),
    ((1, 1, 1, 1, 32), True, 0, 0.0, False),
]
# the Hopper variant's cases, in bf16 only (it takes no f32): the ragged
# length of a real wave, a window wider than a kv tile, sq != skv without
# the causal mask, a softcap, a (b, h, s, hd) storage, and Jamba's 64
# heads
HOPPER_CASES = [
    ((4, 916, 916, 32, 128), True, 0, 0.0, False),
    ((2, 700, 700, 8, 128), True, 257, 0.0, False),
    ((1, 200, 333, 4, 64), False, 0, 0.0, False),
    ((1, 300, 300, 4, 128), True, 0, 30.0, False),
    ((1, 300, 300, 4, 128), True, 0, 0.0, True),
    ((2, 1024, 1024, 64, 128), True, 0, 0.0, False),
]
KERNEL_CASES = (
    [pytest.param(*case, dtype, id=f"case{i}-{name}")
     for i, case in enumerate(CASES)
     for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))]
    + [pytest.param(*case, torch.bfloat16, id=f"hopper{i}-bf16")
       for i, case in enumerate(HOPPER_CASES)])


@pytest.mark.parametrize("shape,causal,window,softcap,strided,dtype",
                         KERNEL_CASES)
def test_kernel_matches_plain(cuda, shape, causal, window, softcap, strided,
                              dtype):
    q, k, v = _qkv(*shape, dtype, strided=strided)
    kw = dict(causal=causal, window=window, softcap=softcap)
    # the Hopper variant takes every bf16 call with hd 64 or 128 here
    variant = ("hopper" if dtype == torch.bfloat16 and shape[4] in (64, 128)
               else "general")
    assert kernel.plan(q, k, v) == variant
    before = ops.launches
    by_variant = dict(ops.launches_by_variant)
    with torch.inference_mode():
        out = ops.flash_attention(q, k, v, **kw)
        ref = attention_ref(q, k, v, **kw)
    assert ops.launches == before + 1
    by_variant[variant] += 1
    assert ops.launches_by_variant == by_variant
    b, sq, _, h, hd = shape
    assert out.shape == (b, sq, h, hd) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    row = ((out.float() - ref.float()).norm(dim=-1)
           / ref.float().norm(dim=-1).clamp_min(1e-30))
    assert row.max().item() <= ROW_TOL[dtype]


def test_cuda_grad_raises(cuda):
    q, k, v = _qkv(1, 16, 16, 1, 16, torch.float32)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.flash_attention(q, k, v)
    with torch.no_grad():
        ops.flash_attention(q, k, v)


def test_cuda_rejects_rows_without_a_key(cuda):
    q, k, v = _qkv(1, 24, 16, 1, 16, torch.float32)
    before = ops.launches
    with pytest.raises(ValueError, match="no key"):
        ops.flash_attention(q, k, v, window=8)
    assert ops.launches == before


def test_hopper_variant_raises_on_what_it_does_not_take(cuda):
    """Called directly with a head dim, a dtype or a window it does not
    take, the Hopper variant raises; nothing runs the general one in its
    place, and nothing counts a launch."""
    before = ops.launches
    q, k, v = _qkv(1, 64, 64, 2, 32, torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernel.flash_attention_cuda(q, k, v, "hopper")
    q, k, v = _qkv(1, 24, 16, 1, 64, torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernel.flash_attention_cuda(q, k, v, "hopper", window=8)
    q, k, v = _qkv(1, 64, 64, 2, 64, torch.bfloat16)
    q = q[:, :, :, :60]   # a 120-byte head: no tensor map
    with pytest.raises(RuntimeError, match="CUDA error|tensor map"):
        kernel.flash_attention_cuda(q, k[..., :60], v[..., :60], "hopper")
    assert ops.launches == before
    torch.cuda.synchronize()


def test_cuda_rejects_other_dtypes(cuda):
    q, k, v = _qkv(1, 16, 16, 1, 16, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q, k, v)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma3-4b",
                                  "minicpm-2b"])
def test_prefill_on_the_card_matches_cpu(cuda, arch):
    """Prefill runs the kernel once per layer, and its f32 logits and cache
    equal the same model's on the CPU (plain attention there).  1e-4, not
    2e-5: every product and reduction of every layer sums in another
    order on the card than on the CPU."""
    cfg = get_smoke(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    on_card = _to(params, cuda)
    with torch.inference_mode():
        want, want_cache, _ = model.prefill(params, tokens, 48)
        before = ops.launches
        got, got_cache, length = model.prefill(on_card, tokens.to(cuda), 48)
        torch.cuda.synchronize()
    assert ops.launches == before + cfg.n_layers
    assert length == 40
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_cache["k"].cpu(), want_cache["k"],
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ WKV6 (K2)

# inputs and limits: repro_torch.kernels.rwkv6.checks, as chip_smoke.py


def _wkv_inputs(b, s, h, hd, dtype, strided=False, state_scale=0.0,
                seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return checks.inputs((b, s, h, hd), dtype, gen, strided, state_scale)


def _assert_close(out, ref, tol, row_tol):
    out, ref = out.float(), ref.float()
    scale = ref.pow(2).mean().sqrt().item()
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol * scale)
    row = (out - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    assert row.max().item() <= row_tol


# (b, s, h, hd), strided, scale of the initial state
WKV_CASES = [
    ((2, 1, 4, 64), False, 10.0),
    ((2, 37, 4, 16), True, 10.0),
    ((1, 100, 3, 24), False, 0.0),
    ((2, 300, 4, 64), True, 10.0),
    ((1, 1000, 2, 32), False, 10.0),
    ((2, 33, 4, 64), False, 10.0),       # one ragged chunk after two
    ((2, 33, 3, 24), True, 10.0),
]


def _plan_id(candidate):
    groups, cols, col_blocks, pipelined = candidate
    return (f"G{groups}-C{cols}-CB{col_blocks}"
            + ("" if pipelined else "-nopipe"))


@pytest.mark.parametrize("candidate", wkv_kernel.CANDIDATES, ids=_plan_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,strided,state_scale", WKV_CASES)
def test_wkv6_kernel_matches_plain(cuda, shape, strided, state_scale,
                                   dtype, candidate):
    """Every timed (G, C, CB) with and without the overlapped copies,
    through the sweep library with an explicit plan, at every case (hd 16
    and 24 with every G, so G > 1 on padded lanes too) where the plan has
    an instantiation."""
    plan, pipelined = candidate[:3], candidate[3]
    if not wkv_kernel.fits(shape[3], plan, sweep=True):
        with pytest.raises(ValueError, match="no WKV6 plan"):
            wkv_kernel.wkv6_cuda(*_wkv_inputs(*shape, dtype), plan,
                                 sweep=True)
        return
    args = _wkv_inputs(*shape, dtype, strided, state_scale)
    r, k, v, w, u, s0 = args
    with torch.inference_mode():
        y, S = wkv_kernel.wkv6_cuda(r, k, v, w, u.float(), s0, plan,
                                    pipelined, sweep=True)
        y_ref, S_ref = wkv6_ref(*args)
    b, s, h, hd = shape
    assert y.shape == (b, s, h, hd) and y.dtype == dtype
    assert S.shape == (b, h, hd, hd) and S.dtype == torch.float32
    _assert_close(y, y_ref, checks.TOL[dtype], checks.ROW_TOL[dtype])
    _assert_close(S, S_ref, checks.STATE_TOL, checks.STATE_ROW_TOL)


@pytest.mark.parametrize("shape,strided,state_scale", WKV_CASES[:3])
def test_wkv6_dispatch_launches_the_plan(cuda, shape, strided,
                                         state_scale):
    """ops.wkv6 launches once, under kernel.plan's (G, C, CB), and returns
    what the kernel module returns for that plan, from the serving
    library and from the sweep library alike."""
    args = _wkv_inputs(*shape, torch.bfloat16, strided, state_scale)
    plan = wkv_kernel.plan(shape, torch.bfloat16)
    before = wkv_ops.launches
    by_plan = dict(wkv_ops.launches_by_plan)
    with torch.inference_mode():
        y, S = wkv_ops.wkv6(*args)
        r, k, v, w, u, s0 = args
        y2, S2 = wkv_kernel.wkv6_cuda(r, k, v, w, u.float(), s0, plan)
        y3, S3 = wkv_kernel.wkv6_cuda(r, k, v, w, u.float(), s0, plan,
                                      sweep=True)
    assert wkv_ops.launches == before + 1
    assert wkv_ops.launches_by_plan[plan] == by_plan.get(plan, 0) + 1
    assert torch.equal(y, y2) and torch.equal(S, S2)
    assert torch.equal(y, y3) and torch.equal(S, S3)


def test_wkv6_copies_rows_at_any_alignment(cuda):
    """Rows that are 2, 4 or 8 bytes aligned (views at an odd element
    offset) take the smaller copies and still match the plain version."""
    b, s, h, hd = 2, 40, 3, 24
    gen = torch.Generator(device="cuda").manual_seed(5)
    # rows 448 (bf16) and 304 (f32) bytes apart: the offset sets the
    # alignment (bf16 at 1, 2, 4 elements: 2, 4, 8 bytes; f32: 4, 8, 16)
    for off in (1, 2, 4):
        base = torch.randn((b, s, 3 * h * hd + 8), generator=gen,
                           device="cuda").to(torch.bfloat16)
        r, k, v = (base[..., off + i * h * hd:off + (i + 1) * h * hd]
                   .view(b, s, h, hd) for i in range(3))
        wbase = torch.rand((b, s, h * hd + 4), generator=gen,
                           device="cuda") * 0.1 + 0.9
        w = wbase[..., off:off + h * hd].view(b, s, h, hd)
        u = torch.randn((h, hd), generator=gen, device="cuda") * 0.1
        s0 = torch.randn((b, h, hd, hd), generator=gen, device="cuda")
        with torch.inference_mode():
            y, S = wkv_ops.wkv6(r, k, v, w, u, s0)
            y_ref, S_ref = wkv6_ref(r, k, v, w, u, s0)
        _assert_close(y, y_ref, checks.TOL[torch.bfloat16],
                      checks.ROW_TOL[torch.bfloat16])
        _assert_close(S, S_ref, checks.STATE_TOL, checks.STATE_ROW_TOL)


def test_wkv6_cuda_grad_raises(cuda):
    r, k, v, w, u, s0 = _wkv_inputs(1, 8, 1, 16, torch.float32)
    r.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        wkv_ops.wkv6(r, k, v, w, u, s0)
    with torch.no_grad():
        wkv_ops.wkv6(r, k, v, w, u, s0)


def test_wkv6_cuda_rejects_what_the_kernel_does_not_take(cuda):
    r, k, v, w, u, s0 = _wkv_inputs(1, 8, 2, 16, torch.float32)
    before = wkv_ops.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wkv_ops.wkv6(r.half(), k.half(), v.half(), w, u, s0)
    with pytest.raises(TypeError, match="float32 w and state"):
        wkv_ops.wkv6(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(TypeError, match="float32 w and state"):
        wkv_ops.wkv6(r, k, v, w, u, s0.bfloat16())
    with pytest.raises(TypeError, match="u in float32 or bfloat16"):
        wkv_ops.wkv6(r, k, v, w, u.half(), s0)
    big = _wkv_inputs(1, 4, 1, 128, torch.float32)
    with pytest.raises(ValueError, match="head dim 128"):
        wkv_ops.wkv6(*big)
    with pytest.raises(ValueError, match="stride 1"):
        wkv_ops.wkv6(*(t.transpose(2, 3).contiguous().transpose(2, 3)
                       for t in (r, k, v, w)), u, s0)
    assert wkv_ops.launches == before


def test_rwkv_prefill_on_the_card_matches_cpu(cuda):
    """Prefill runs K2 once per layer; its f32 logits and state equal the
    same model's on the CPU (the plain recurrence there).  1e-4, not 2e-5:
    every product and reduction sums in another order on the card."""
    cfg = get_smoke("rwkv6-1.6b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    on_card = _to(params, cuda)
    with torch.inference_mode():
        want, want_state, _ = model.prefill(params, tokens, 0)
        before = wkv_ops.launches
        got, got_state, length = model.prefill(on_card, tokens.to(cuda), 0)
        torch.cuda.synchronize()
    assert wkv_ops.launches == before + cfg.n_layers
    assert length == 40
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for key in ("wkv", "tm_x", "cm_x"):
        torch.testing.assert_close(got_state[key].cpu(), want_state[key],
                                   rtol=1e-4, atol=1e-4)


# ------------------------------------------------- selective scan (K3)

# inputs and limits: repro_torch.kernels.mamba_scan.checks, as
# chip_smoke.py


def _scan_inputs(b, s, di, n, dtype, state_scale=0.0, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return scan_checks.inputs((b, s, di, n), dtype, gen, state_scale)


# (b, s, di, N), scale of the initial state
SCAN_CASES = [
    ((2, 2, 256, 16), 10.0),
    ((2, 33, 200, 16), 10.0),
    ((1, 100, 130, 8), 0.0),
    ((3, 37, 64, 4), 10.0),
    ((1, 1, 128, 16), 10.0),
    ((2, 700, 512, 16), 0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,state_scale", SCAN_CASES)
def test_selective_scan_kernel_matches_plain(cuda, shape, state_scale,
                                             dtype):
    args = _scan_inputs(*shape, dtype, state_scale)
    before = scan_ops.launches
    with torch.inference_mode():
        y, h = scan_ops.selective_scan(*args)
        y_ref, h_ref = selective_scan_ref(*args)
    assert scan_ops.launches == before + 1
    b, s, di, n = shape
    assert y.shape == (b, s, di) and y.dtype == dtype
    assert h.shape == (b, di, n) and h.dtype == torch.float32
    _assert_close(y, y_ref, scan_checks.TOL[dtype],
                  scan_checks.ROW_TOL[dtype])
    _assert_close(h, h_ref, scan_checks.STATE_TOL,
                  scan_checks.STATE_ROW_TOL)


def test_selective_scan_cuda_grad_raises(cuda):
    x, dt, A, B, C, D, h0 = _scan_inputs(1, 8, 16, 4, torch.float32)
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        scan_ops.selective_scan(x, dt, A, B, C, D, h0)
    with torch.no_grad():
        scan_ops.selective_scan(x, dt, A, B, C, D, h0)


def test_selective_scan_cuda_rejects_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C, D, h0 = _scan_inputs(1, 8, 16, 4, torch.float32)
    before = scan_ops.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        scan_ops.selective_scan(x.half(), dt, A, B.half(), C.half(), D, h0)
    with pytest.raises(TypeError, match="of one dtype"):
        scan_ops.selective_scan(x, dt, A, B.bfloat16(), C, D, h0)
    for i, name in ((1, "dt"), (2, "A"), (5, "D"), (6, "state")):
        args = [x, dt, A, B, C, D, h0]
        args[i] = args[i].bfloat16()
        with pytest.raises(TypeError, match="float32 dt, A, D and state"):
            scan_ops.selective_scan(*args)
    big = _scan_inputs(1, 4, 16, 32, torch.float32)
    with pytest.raises(ValueError, match="state size 32"):
        scan_ops.selective_scan(*big)
    with pytest.raises(ValueError, match="stride 1"):
        scan_ops.selective_scan(x.transpose(1, 2).contiguous().transpose(
            1, 2), dt, A, B, C, D, h0)
    with pytest.raises(ValueError, match="different devices"):
        scan_ops.selective_scan(x, dt, A.cpu(), B, C, D, h0)
    assert scan_ops.launches == before


def test_jamba_prefill_on_the_card_matches_cpu(cuda):
    """Prefill runs K1 once per period and K3 once per Mamba layer; its
    f32 logits and cache equal the same model's on the CPU (the plain
    versions there).  1e-4, not 2e-5: every product and reduction sums in
    another order on the card."""
    cfg = get_smoke("jamba-1.5-large-398b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    on_card = _to(params, cuda)
    with torch.inference_mode():
        want, want_cache, _ = model.prefill(params, tokens, 48)
        k1, k3 = ops.launches, scan_ops.launches
        got, got_cache, length = model.prefill(on_card, tokens.to(cuda), 48)
        torch.cuda.synchronize()
    assert ops.launches == k1 + model.n_periods
    assert scan_ops.launches == k3 + model.n_periods * model.n_mamba
    assert length == 40
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for kind, key in (("attn", "k"), ("attn", "v"), ("mamba", "ssm"),
                      ("mamba", "conv")):
        torch.testing.assert_close(got_cache[kind][key].cpu(),
                                   want_cache[kind][key], rtol=1e-4,
                                   atol=1e-4)


def test_moe_bf16_expert_products_write_f32_on_the_card(cuda):
    """bf16 expert weights give f32 products on the card without being
    converted, equal to the CPU's product of converted operands up to the
    order of the f32 sums; a bf16 ``apply_moe`` on the card agrees with
    the CPU's at the bf16 limit."""
    from repro_torch.models import moe as M
    gen = torch.Generator().manual_seed(5)
    a = torch.randn((4, 24, 64), generator=gen).bfloat16()
    w = (torch.randn((4, 64, 96), generator=gen) * 0.125).bfloat16()
    got = M._bmm_f32(a.to(cuda), w.to(cuda))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), M._bmm_f32(a, w), rtol=1e-5,
                               atol=1e-5)
    cfg = get_smoke("mixtral-8x7b")
    assert cfg.dtype == "bfloat16"
    p = M.init_moe(torch.Generator().manual_seed(6), cfg, torch.bfloat16,
                   "cpu")
    x = torch.randn((2, 12, cfg.d_model), generator=gen).bfloat16()
    want, _ = M.apply_moe(x, p, cfg)
    with torch.inference_mode():
        got, _ = M.apply_moe(x.to(cuda), _to(p, cuda), cfg)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.cpu(), want, rtol=5e-2, atol=5e-2)
