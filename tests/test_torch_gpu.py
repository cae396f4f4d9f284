"""The port on the card: the CUDA flash attention (K1, forward and
backward), WKV6 (K2, forward and backward) and selective scan (K3,
forward and backward) kernels against their plain versions (K1 at
whisper-tiny's shapes too), the dispatchers' rules for CUDA tensors,
DecoderLM, RWKVLM, JambaLM and WhisperLM prefill through the kernels
(and WhisperLM's decode) against the same models on the CPU, and
DecoderLM's, RWKVLM's, JambaLM's and WhisperLM's losses, gradients and
train steps on the card, and DecoderLM serving on meshes of ranks that
share the card (gloo) and on a one-rank NCCL mesh.

Every test here needs an NVIDIA GPU and skips without one.  On a machine
with a card, from the repository root:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it also runs where JAX is not installed.
"""
from __future__ import annotations

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import \
    checks as flash_checks  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.kernels.flash_attention.ref import \
    attention_lse as ref_lse  # noqa: E402
from repro_torch.kernels.mamba_scan import checks as scan_checks  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as scan_kernel  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import checks  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.rwkv6 import \
    kernel_bwd as wkv_kernel_bwd  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6.checks import \
    bwd_inputs as wkv_checks_bwd_inputs  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref, wkv6_ref  # noqa: E402
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


def _qkv(b, sq, skv, h, hd, dtype, layout="plain", seed=0, dv=None):
    """q, k ~ N(0, 4), v ~ N(0, 1): each row's softmax peaks on a few
    keys, so |out| is O(1) in every row and a lost or doubled kv tile
    moves the rows that attend into it by O(1).  v has dv columns (hd if
    None).  ``layout``: "plain" (b, s, h, hd); "strided", a (b, h, s, hd)
    storage seen as (b, s, h, hd); "padded", the first hd columns of a
    (b, s, h, 128) storage whose other columns hold 1e4 (a kernel that
    read them would see scores of about 1e8); "qk-halves", q and k the
    first and last hd columns of one (b, s, h, 2 hd) storage."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(s, scale, d=hd):
        if layout == "strided":
            x = torch.randn((b, h, s, d), generator=gen, device="cuda")
            return (x.transpose(1, 2) * scale).to(dtype)
        if layout == "padded":
            x = torch.randn((b, s, h, 128), generator=gen, device="cuda")
            x = (x * scale).to(dtype)
            x[..., d:] = 1e4
            return x[..., :d]
        x = torch.randn((b, s, h, d), generator=gen, device="cuda")
        return (x * scale).to(dtype)

    q, k = randn(sq, 2.0), randn(skv, 2.0)
    v = randn(skv, 1.0, hd if dv is None else dv)
    if layout == "qk-halves":
        qk = torch.cat([q, k], dim=-1)
        q, k = qk[..., :hd], qk[..., hd:]
    return q, k, v


# (b, sq, skv, h, hd), causal, window, softcap, layout (``_qkv``); each
# in f32 and in bf16
CASES = [
    ((2, 100, 100, 6, 12), True, 0, 0.0, "plain"),
    ((2, 130, 130, 4, 16), True, 16, 0.0, "strided"),
    ((1, 257, 257, 4, 64), True, 64, 0.0, "plain"),
    ((1, 64, 192, 2, 64), False, 0, 0.0, "plain"),
    ((2, 200, 200, 4, 128), True, 0, 0.0, "plain"),
    ((1, 96, 96, 2, 256), True, 0, 30.0, "plain"),
    ((1, 1, 1, 1, 32), True, 0, 0.0, "plain"),
]
# the Hopper variant's cases, in bf16 only (it takes no f32): the ragged
# length of a real wave, a window wider than a kv tile, sq != skv without
# the causal mask, a softcap, a (b, h, s, hd) storage, and Jamba's 64
# heads; at hd 120 (h2o-danube-3-4b: two TMA boxes a row, columns
# 120..127 zero-filled) a ragged wave, sq != skv without the causal
# mask, a softcap, a (b, h, s, hd) storage, and the first 120 columns of
# a 128-column storage
HOPPER_CASES = [
    ((4, 916, 916, 32, 128), True, 0, 0.0, "plain"),
    ((2, 700, 700, 8, 128), True, 257, 0.0, "plain"),
    ((1, 200, 333, 4, 64), False, 0, 0.0, "plain"),
    ((1, 300, 300, 4, 128), True, 0, 30.0, "plain"),
    ((1, 300, 300, 4, 128), True, 0, 0.0, "strided"),
    ((2, 1024, 1024, 64, 128), True, 0, 0.0, "plain"),
    ((4, 916, 916, 32, 120), True, 0, 0.0, "plain"),
    ((1, 200, 333, 4, 120), False, 0, 0.0, "plain"),
    ((1, 300, 300, 4, 120), True, 0, 30.0, "plain"),
    ((1, 300, 300, 4, 120), True, 0, 0.0, "strided"),
    ((2, 300, 300, 4, 120), True, 0, 0.0, "padded"),
    # whisper-tiny's (6 heads of 64, 1500 frames, none causal): a prefill
    # wave's encoder, the cross-attention of 224-token prompts, and of 4-
    # and 1-token prompts, whose one q tile lies almost wholly past sq
    ((4, 1500, 1500, 6, 64), False, 0, 0.0, "plain"),
    ((4, 224, 1500, 6, 64), False, 0, 0.0, "plain"),
    ((4, 4, 1500, 6, 64), False, 0, 0.0, "plain"),
    ((2, 1, 1500, 6, 64), False, 0, 0.0, "plain"),
    # a mesh rank's local heads: mistral-nemo-12b's 16 of 32 on model = 2
    ((2, 1024, 1024, 16, 128), True, 0, 0.0, "plain"),
    # hd 256 (gemma3-4b: 64-row kv tiles, one Q buffer, four TMA boxes a
    # row): a ragged wave, sq != skv without the causal mask, a window
    # that is no multiple of a kv tile, a (b, h, s, hd) storage
    ((2, 333, 333, 4, 256), True, 0, 0.0, "plain"),
    ((1, 200, 333, 4, 256), False, 0, 0.0, "plain"),
    ((2, 700, 700, 2, 256), True, 257, 0.0, "plain"),
    ((1, 300, 300, 4, 256), True, 0, 0.0, "strided"),
]
# long windows, in bf16: hd 120 (h2o-danube-3-4b) and hd 128
# (mixtral-8x7b), both on the Hopper variant, rows past the window, a
# window that is no multiple of a kv tile, a window longer than the
# sequence, and a ragged last tile
WINDOW_CASES = [
    ((1, 1500, 1500, 4, 120), True, 1024, 0.0, "plain"),
    ((2, 1100, 1100, 2, 120), True, 1000, 0.0, "plain"),
    ((1, 2100, 2100, 2, 120), True, 4096, 0.0, "plain"),
    ((1, 1500, 1500, 4, 128), True, 1024, 0.0, "plain"),
    ((2, 2300, 2300, 2, 128), True, 1100, 0.0, "plain"),
    ((1, 3000, 3000, 2, 128), True, 2048, 0.0, "plain"),
]
KERNEL_CASES = (
    [pytest.param(*case, dtype, id=f"case{i}-{name}")
     for i, case in enumerate(CASES)
     for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))]
    + [pytest.param(*case, torch.bfloat16, id=f"hopper{i}-bf16")
       for i, case in enumerate(HOPPER_CASES)]
    + [pytest.param(*case, torch.bfloat16, id=f"window{i}-hd{case[0][4]}")
       for i, case in enumerate(WINDOW_CASES)])


@pytest.mark.parametrize("shape,causal,window,softcap,layout,dtype",
                         KERNEL_CASES)
def test_kernel_matches_plain(cuda, shape, causal, window, softcap, layout,
                              dtype):
    q, k, v = _qkv(*shape, dtype, layout=layout)
    kw = dict(causal=causal, window=window, softcap=softcap)
    # the Hopper variant takes every bf16 call with hd 64, 120, 128 or 256
    # here (v at hd, (hd, hd) in kernel.HOPPER_HEAD_DIM_PAIRS)
    variant = ("hopper" if dtype == torch.bfloat16
               and (shape[4], shape[4]) in kernel.HOPPER_HEAD_DIM_PAIRS
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
    """A gradient past the kernels' head dims (257, past the forward's
    256) raises before any launch; one at hd 256 launches the forward and
    the backward's three kernels, its gradients those of
    attention_bwd_ref row by row."""
    q, k, v = _qkv(1, 16, 16, 1, 257, torch.float32)
    q.requires_grad_(True)
    before = (ops.launches, ops.launches_bwd)
    with pytest.raises(ValueError, match="head dim 257"):
        ops.flash_attention(q, k, v)
    assert (ops.launches, ops.launches_bwd) == before
    q, k, v = (t.requires_grad_() for t in _qkv(1, 80, 80, 2, 256,
                                                 torch.float32, seed=2))
    o = ops.flash_attention(q, k, v)
    do = torch.randn_like(o)
    got = torch.autograd.grad(o, (q, k, v), do)
    assert (ops.launches, ops.launches_bwd) == (
        before[0] + 1, before[1] + len(kernel_bwd.KERNELS["general"]))
    f32 = [t.detach() for t in (q, k, v, o, do)]
    ref = attention_bwd_ref(*f32)
    scales = flash_checks.bwd_row_scales(*f32)
    for a, r, m in zip(got, ref, scales):
        assert flash_checks.grad_row_err(a, r, m) <= ROW_TOL[torch.float32]


@pytest.mark.parametrize("entry", ["forward", "backward"])
def test_hopper_as_a_threads_first_cuda_call(cuda, entry):
    """K1's Hopper forward (training mode) and backward encode their
    tensor maps in a thread whose first CUDA call they are, as autograd's
    backward thread can be (no context is current there until the entry
    binds the device's), and give the bits they give on this thread."""
    import threading
    q, k, v = _qkv(2, 150, 150, 4, 128, torch.bfloat16, seed=8)
    lse = kernel.lse_buffer(q)
    with torch.no_grad():
        o = kernel.flash_attention_cuda(q, k, v, "hopper", lse=lse)
    do = torch.randn_like(o)
    if entry == "forward":
        def call():
            out = kernel.lse_buffer(q)
            return (kernel.flash_attention_cuda(q, k, v, "hopper", lse=out),
                    out[..., :q.shape[1]])
    else:
        def call():
            return kernel_bwd.flash_attention_bwd_cuda(q, k, v, o, do,
                                                       "hopper", lse=lse)
    want = call()
    torch.cuda.synchronize()
    got = []
    thread = threading.Thread(target=lambda: got.append(call()))
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive() and len(got) == 1
    torch.cuda.synchronize()
    for a, b in zip(got[0], want):
        assert torch.equal(a, b)


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
    # hd 120 has no training mode (the Hopper backward takes no hd 120)
    q, k, v = _qkv(1, 64, 64, 2, 120, torch.bfloat16)
    with pytest.raises(ValueError, match="lse only at hd"):
        kernel.flash_attention_cuda(q, k, v, "hopper",
                                    lse=kernel.lse_buffer(q))
    # nor has MLA's (192, 128); and no instantiation takes (192, 192)
    q, k, v = _qkv(1, 64, 64, 2, 192, torch.bfloat16, dv=128)
    with pytest.raises(ValueError, match="lse only at hd"):
        kernel.flash_attention_cuda(q, k, v, "hopper",
                                    lse=kernel.lse_buffer(q))
    q, k, v = _qkv(1, 64, 64, 2, 192, torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernel.flash_attention_cuda(q, k, v, "hopper")
    # nor (256, 128): hd 256 is Hd256Tile's, v at 256 columns
    q, k, v = _qkv(1, 64, 64, 2, 256, torch.bfloat16, dv=128)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernel.flash_attention_cuda(q, k, v, "hopper")
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
                                  "minicpm-2b", "h2o-danube-3-4b",
                                  "mixtral-8x7b", "internvl2-76b"])
def test_prefill_on_the_card_matches_cpu(cuda, arch):
    """Prefill runs the kernel once per layer, and its f32 logits and cache
    equal the same model's on the CPU (plain attention there): the static
    window of 16 (danube, mixtral) past a 40-token prompt, and internvl2
    with its 8 patch embeddings in front.  1e-4, not 2e-5: every product
    and reduction of every layer sums in another order on the card than
    on the CPU."""
    cfg = get_smoke(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    patches = None
    if cfg.n_vision_patches:
        patches = torch.randn((2, cfg.n_vision_patches, cfg.d_model),
                              generator=torch.Generator().manual_seed(2))
    on_card = _to(params, cuda)
    with torch.inference_mode():
        want, want_cache, want_len = model.prefill(params, tokens, 48,
                                                   patches)
        before = ops.launches
        got, got_cache, length = model.prefill(
            on_card, tokens.to(cuda), 48,
            None if patches is None else patches.to(cuda))
        torch.cuda.synchronize()
    assert ops.launches == before + cfg.n_layers
    assert length == want_len == 40 + cfg.n_vision_patches
    assert got_cache["k"].shape[2] == 48 + cfg.n_vision_patches
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


def _row_err(out, ref):
    """Worst ||out - ref|| / ||ref|| over the rows (the last dim), in f64."""
    out, ref = out.double(), ref.double()
    return ((out - ref).norm(dim=-1)
            / ref.norm(dim=-1).clamp_min(1e-30)).max().item()


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
    """A CUDA call that needs a gradient raises only where the kernels do
    not go (head dim past 64, before any launch); at hd 16 it launches the
    forward kernel once and, in the backward, the backward's kernels."""
    big = [t.requires_grad_(t.is_floating_point())
           for t in _wkv_inputs(1, 4, 1, 128, torch.float32)]
    before = (wkv_ops.launches, wkv_ops.launches_bwd)
    with pytest.raises(ValueError, match="head dim 128"):
        wkv_ops.wkv6(*big)
    r, k, v, w, u, s0 = _wkv_inputs(1, 8, 1, 16, torch.float32)
    r.requires_grad_(True)
    y, _ = wkv_ops.wkv6(r, k, v, w, u, s0)
    y.sum().backward()
    assert (wkv_ops.launches - before[0],
            wkv_ops.launches_bwd - before[1]) == (1, len(wkv_kernel_bwd.KERNELS))
    assert torch.isfinite(r.grad).all()


# K2's backward: (b, s, h, hd), dtype, strided, scale of S_0, scale of dS_T,
# fast decay (w down to 0)
WKV_BWD_CASES = [
    ((2, 37, 4, 16), torch.float32, True, 10.0, 1.0, False),
    ((2, 100, 4, 24), torch.float32, False, 10.0, 1.0, False),
    ((3, 45, 2, 33), torch.bfloat16, True, 10.0, 1.0, False),
    ((1, 130, 2, 32), torch.bfloat16, False, 0.0, 0.0, False),
    ((2, 300, 4, 64), torch.float32, False, 10.0, 1.0, True),
    ((2, 1000, 8, 64), torch.bfloat16, True, 10.0, 1.0, False),
    ((1, 2047, 4, 64), torch.float32, False, 10.0, 1.0, False),
    ((4, 2048, 32, 64), torch.bfloat16, False, 0.0, 0.0, False),
]


@pytest.mark.parametrize("route", wkv_kernel_bwd.ROUTES)
@pytest.mark.parametrize("shape,dtype,strided,state_scale,dstate_scale,fast",
                         WKV_BWD_CASES)
def test_wkv6_bwd_kernel_matches_plain(cuda, shape, dtype, strided,
                                       state_scale, dstate_scale, fast,
                                       route):
    """The backward's kernels on each route against wkv6_bwd_ref: every
    gradient row within its limit against its scale (checks.BWD_ROW_TOL),
    finite, the same bits twice; the "hopper" route (its checkpoints from
    the forward in training mode) raises before any launch at a head dim
    other than 64."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    r, k, v, w, u, s0, dy, ds = wkv_checks_bwd_inputs(
        shape, dtype, gen, strided, state_scale, dstate_scale, fast)
    uf = u.float()
    if route == "hopper" and shape[3] != wkv_kernel_bwd.HOPPER_HEAD_DIM:
        with pytest.raises(ValueError, match="hopper route takes"):
            wkv_kernel_bwd.wkv6_bwd_cuda(r, k, v, w, uf, s0, dy, ds,
                                         route=route)
        return
    got = wkv_kernel_bwd.wkv6_bwd_cuda(r, k, v, w, uf, s0, dy, ds,
                                       route=route)
    again = wkv_kernel_bwd.wkv6_bwd_cuda(r, k, v, w, uf, s0, dy, ds,
                                         route=route)
    ref = wkv6_bwd_ref(r, k, v, w, uf, s0, dy, ds)
    scales = checks.bwd_row_scales(r, k, v, w, uf, s0, dy, ds)
    errs = checks.bwd_errors(got, ref, scales)
    assert checks.bwd_within(errs, dtype), errs
    assert all(torch.isfinite(g).all() for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [g.dtype for g in got] == [dtype] * 3 + [torch.float32] * 3


@pytest.mark.parametrize("tile", wkv_kernel_bwd.SWEEP_TILES,
                         ids=lambda t: "R{}-C{}-SUB{}".format(*t))
@pytest.mark.parametrize("shape,dtype,strided,state_scale,dstate_scale,fast",
                         [c for c in WKV_BWD_CASES if c[0][3] == 64][:3])
def test_wkv6_bwd_hopper_tiles_match_plain(cuda, shape, dtype, strided,
                                           state_scale, dstate_scale, fast,
                                           tile):
    """Every tile of the sweep library, its checkpoints from the forward
    at its own steps, within the limits of dr, dk, dw and du."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    r, k, v, w, u, s0, dy, ds = wkv_checks_bwd_inputs(
        shape, dtype, gen, strided, state_scale, dstate_scale, fast)
    uf = u.float()
    got = wkv_kernel_bwd.wkv6_bwd_cuda(r, k, v, w, uf, s0, dy, ds,
                                       route="hopper", tile=tile, sweep=True)
    ref = wkv6_bwd_ref(r, k, v, w, uf, s0, dy, ds)
    scales = checks.bwd_row_scales(r, k, v, w, uf, s0, dy, ds)
    errs = checks.bwd_errors(got, ref, scales)
    limits = checks.BWD_ROW_TOL[dtype]
    assert all(errs[g] <= limits[g] for g in ("dr", "dk", "dw", "du")), errs


def test_wkv6_bwd_hopper_as_a_threads_first_cuda_call(cuda):
    """The Hopper route's entry encodes its tensor maps in a thread whose
    first CUDA call it is, as autograd's backward thread can be (no
    context was current there: CUDA_ERROR_INVALID_CONTEXT), and gives
    the bits it gives on this thread."""
    import threading
    gen = torch.Generator(device="cuda").manual_seed(14)
    r, k, v, w, u, s0, dy, ds = wkv_checks_bwd_inputs(
        (2, 100, 4, 64), torch.bfloat16, gen, False, 1.0, 1.0, False)
    uf = u.float()
    ck = wkv_kernel_bwd.forward_checkpoints(r, k, v, w, uf, s0,
                                            wkv_kernel_bwd.PLAN[2])
    args = (r, k, v, w, uf, s0, dy, ds)
    kw = dict(kernels=("bwd",), route="hopper", checkpoints=ck)
    want = wkv_kernel_bwd.wkv6_bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    got = []
    thread = threading.Thread(target=lambda: got.append(
        wkv_kernel_bwd.wkv6_bwd_cuda(*args, **kw)))
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive() and len(got) == 1
    torch.cuda.synchronize()
    for a, b in zip(got[0][:2] + got[0][3:5], want[:2] + want[3:5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,strided,steps", [
    ((2, 300, 4, 64), False, 8), ((1, 2047, 4, 64), True, 8),
    ((2, 37, 2, 64), False, 4), ((1, 5, 1, 64), False, 16)])
def test_wkv6_training_mode_forward(cuda, shape, strided, steps, dtype):
    """K2's forward in training mode: y and the final state bit-identical
    to serving mode, and its checkpoints (put back in place) equal to
    ref.wkv6_checkpoints within the forward's state limits."""
    from repro_torch.kernels.rwkv6.ref import wkv6_checkpoints
    r, k, v, w, u, s0 = _wkv_inputs(*shape, dtype, strided, 1.0)
    uf = u.float()
    plan = wkv_kernel.plan(shape, dtype)
    ck = torch.empty(wkv_kernel_bwd.checkpoint_shape(shape, steps),
                     device="cuda")
    with torch.no_grad():
        y0, S0 = wkv_kernel.wkv6_cuda(r, k, v, w, uf, s0, plan)
        y1, S1 = wkv_kernel.wkv6_cuda(r, k, v, w, uf, s0, plan,
                                      checkpoints=ck, ck_steps=steps)
        want = wkv6_checkpoints(k, v, w, s0, steps)
    assert torch.equal(y0, y1) and torch.equal(S0, S1)
    _assert_close(wkv_kernel_bwd.checkpoint_states(ck), want,
                  checks.STATE_TOL, checks.STATE_ROW_TOL)


def test_wkv6_grad_through_ops_launches_the_backward(cuda):
    """Through ops.wkv6 with gradients: one forward launch, the backward's
    kernels once each, on the "hopper" route, and the grads are
    wkv6_bwd_cuda's (its checkpoints from the same forward kernel in
    training mode; u's cast back to bf16 through u.float())."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    ins = wkv_checks_bwd_inputs((2, 70, 4, 64), torch.bfloat16, gen, False,
                                1.0, 1.0, False)
    r, k, v, w, u, s0, dy, ds = ins
    leaves = [t.detach().clone().requires_grad_() for t in (r, k, v, w, u,
                                                             s0)]
    before = (wkv_ops.launches, wkv_ops.launches_bwd,
              wkv_ops.launches_bwd_by_route["hopper"])
    y, s_out = wkv_ops.wkv6(*leaves)
    grads = torch.autograd.grad((y, s_out), leaves, (dy, ds))
    assert (wkv_ops.launches - before[0], wkv_ops.launches_bwd - before[1],
            wkv_ops.launches_bwd_by_route["hopper"] - before[2]
            ) == (1,) + (len(wkv_kernel_bwd.KERNELS),) * 2
    want = wkv_kernel_bwd.wkv6_bwd_cuda(r, k, v, w, u.float(), s0, dy, ds)
    for g, wnt in zip(grads[:4] + grads[5:], want[:4] + want[5:]):
        assert torch.equal(g, wnt)
    assert grads[4].dtype == torch.bfloat16
    assert torch.equal(grads[4], want[4].to(torch.bfloat16))


@pytest.mark.parametrize("head_dim,route", [(16, "general"),
                                            (64, "hopper")])
def test_rwkv_loss_and_grads_on_the_card_match_cpu(cuda, head_dim, route):
    """RWKVLM.loss and its gradients in f32 on the card (K2's forward and
    backward kernels, remat) equal the CPU's (the plain recurrence under
    autograd): loss 1e-4, each gradient leaf within 1e-3 of its largest
    |g|; K2's forward twice and its backward once a layer, on the route
    of the head dim (the smoke config's 16, or 64 as rwkv6-1.6b's, with
    its forward in training mode)."""
    from repro_torch import tree as T
    from repro_torch.configs.base import RWKVConfig
    from repro_torch.training.step import value_and_grad
    cfg = get_smoke("rwkv6-1.6b").replace(dtype="float32")
    if head_dim != cfg.head_dim:
        cfg = cfg.replace(d_model=2 * head_dim, n_heads=2, n_kv_heads=2,
                          head_dim=head_dim,
                          rwkv=RWKVConfig(head_dim=head_dim, decay_lora=8,
                                          mix_lora=4))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=rng)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = value_and_grad(model, params, batch)
    before = (wkv_ops.launches, wkv_ops.launches_bwd,
              wkv_ops.launches_bwd_by_route[route])
    got = value_and_grad(model, _to(params, cuda), _to(batch, cuda))
    n = cfg.n_layers
    assert (wkv_ops.launches - before[0],
            wkv_ops.launches_bwd - before[1],
            wkv_ops.launches_bwd_by_route[route] - before[2]) == (
        2 * n, len(wkv_kernel_bwd.KERNELS) * n,
        len(wkv_kernel_bwd.KERNELS) * n)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    for (path, g), w in zip(T.flatten(got[2]), T.leaves(want[2])):
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-3 * w.abs().max().item(), path


def test_rwkv_train_launcher_on_the_card(cuda):
    """The launcher's rwkv6-1.6b smoke run on the card: finite losses."""
    from repro_torch.launch import train as launch_train
    out = launch_train.run(get_smoke("rwkv6-1.6b"), steps=6, batch=2,
                           seq=64, device="cuda", log=lambda *a: None)
    losses = [r["loss"] for r in out["records"]]
    assert len(losses) == 6 and all(map(math.isfinite, losses))


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


def _scan_inputs(b, s, di, n, dtype, state_scale=0.0, seed=0, **opts):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return scan_checks.inputs((b, s, di, n), dtype, gen, state_scale,
                              **opts)


# (b, s, di, N), scale of the initial state, options of checks.inputs
LARGE_DT = dict(dt_bias=6.0, dt_scale=2.0)    # dt A log2 e < -150 often
SCAN_CASES = [
    ((2, 2, 256, 16), 10.0, {}),
    ((2, 33, 200, 16), 10.0, {}),
    ((1, 100, 130, 8), 0.0, {}),
    ((3, 37, 64, 4), 10.0, {}),
    ((1, 1, 128, 16), 10.0, {}),
    ((2, 700, 512, 16), 0.0, {}),
    ((2, 100, 640, 16), 10.0, LARGE_DT),
    ((2, 1000, 384, 16), 10.0, {}),           # 31 chunks of 32 and 8
    ((2, 47, 333, 8), 10.0, dict(A_kind="shuffled")),
    ((2, 65, 999, 16), 10.0, {}),             # bf16 rows 1998 B apart
    ((2, 40, 1002, 16), 10.0, {}),            # 4-byte copies in bf16
    ((2, 40, 1004, 4), 10.0, {}),             # 8-byte copies in bf16
]
SCAN_IDS = [f"{'x'.join(map(str, shape))}" + "".join(
    f"-{k}" for k in opts) for shape, _, opts in SCAN_CASES]


def _scan_check(out, ref, dtype):
    (y, h), (y_ref, h_ref) = out, ref
    _assert_close(y, y_ref, scan_checks.TOL[dtype],
                  scan_checks.ROW_TOL[dtype])
    _assert_close(h, h_ref, scan_checks.STATE_TOL,
                  scan_checks.STATE_ROW_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,state_scale,opts", SCAN_CASES, ids=SCAN_IDS)
def test_selective_scan_kernel_matches_plain(cuda, shape, state_scale, opts,
                                             dtype):
    """Through the dispatcher: one launch."""
    args = _scan_inputs(*shape, dtype, state_scale, **opts)
    before = scan_ops.launches
    with torch.inference_mode():
        y, h = scan_ops.selective_scan(*args)
        y_ref, h_ref = selective_scan_ref(*args)
    assert scan_ops.launches == before + 1
    b, s, di, n = shape
    assert y.shape == (b, s, di) and y.dtype == dtype
    assert h.shape == (b, di, n) and h.dtype == torch.float32
    _scan_check((y, h), (y_ref, h_ref), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,state_scale,opts", SCAN_CASES, ids=SCAN_IDS)
@pytest.mark.parametrize("design", scan_kernel.CANDIDATES)
def test_selective_scan_candidates_match_plain(cuda, design, shape,
                                               state_scale, opts, dtype):
    """Every design of the sweep library, the first design included, at
    every case, through the kernel module (no launch counted)."""
    args = _scan_inputs(*shape, dtype, state_scale, **opts)
    before = scan_ops.launches
    with torch.inference_mode():
        out = scan_kernel.selective_scan_cuda(*args, design=design,
                                              sweep=True)
        ref = selective_scan_ref(*args)
    assert scan_ops.launches == before
    _scan_check(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_selective_scan_libraries_agree(cuda, dtype):
    """The serving and the sweep library run the same code for
    ``DESIGN``: bit for bit the same y and state."""
    args = _scan_inputs(2, 100, 640, 16, dtype, 10.0)
    with torch.inference_mode():
        y1, h1 = scan_kernel.selective_scan_cuda(*args)
        y2, h2 = scan_kernel.selective_scan_cuda(*args, sweep=True)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_selective_scan_long_memory_holds_to_f64(cuda, dtype):
    """Decays that remember thousands of steps: the kernel's y and final
    state no further from an f64 scan, row by row, than
    ``LONG_MEMORY_RATIO`` times the plain version's (checks.py)."""
    args = _scan_inputs(2, 400, 1024, 16, dtype, 10.0, A_kind="long-memory")
    with torch.inference_mode():
        out = scan_ops.selective_scan(*args)
        plain = selective_scan_ref(*args)
        exact = scan_checks.f64_scan(*args)
    for got, ref, want in zip(out, plain, exact):
        k_err, p_err = _row_err(got, want), _row_err(ref, want)
        assert k_err <= scan_checks.LONG_MEMORY_RATIO * p_err, (k_err, p_err)


def test_ex2_rate_probe_fills_every_sm(cuda):
    """The probe of the SFUs' ex2 rate runs one block on every SM and
    finds a rate within 2% of the programming guide's 16."""
    r = scan_kernel.ex2_rate()
    assert r["finite"] and r["distinct_sms"] == r["sms"]
    assert r["per_sm_per_clock"] == pytest.approx(16, rel=0.02)


# K3's backward: (b, s, di, N), scale of h_0, scale of dh_T, options of
# checks.inputs; s = 1, ragged sub-chunks and channel blocks, N 4/8/16,
# exponentials that underflow
SCAN_BWD_CASES = [
    ((2, 1, 64, 16), 1.0, 1.0, {}),
    ((2, 37, 200, 4), 10.0, 1.0, {}),
    ((1, 100, 130, 8), 0.0, 0.0, {}),
    ((2, 300, 512, 16), 10.0, 1.0, {}),
    ((1, 64, 256, 16), 10.0, 1.0, LARGE_DT),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,state_scale,dstate_scale,opts",
                         SCAN_BWD_CASES)
def test_selective_scan_bwd_kernel_matches_plain(cuda, shape, state_scale,
                                                 dstate_scale, opts, dtype):
    """K3's backward kernels against selective_scan_bwd_ref, every
    gradient row within checks.BWD_ROW_TOL of its scale, the gradients in
    jax.vjp's dtypes, two calls bit for bit."""
    from repro_torch.kernels.mamba_scan import kernel_bwd as scan_bwd
    from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref
    gen = torch.Generator(device="cuda").manual_seed(9)
    *args, dy, ds = scan_checks.bwd_inputs(shape, dtype, gen, state_scale,
                                           dstate_scale, **opts)
    got = scan_bwd.selective_scan_bwd_cuda(*args, dy, ds)
    again = scan_bwd.selective_scan_bwd_cuda(*args, dy, ds)
    with torch.no_grad():
        ref = selective_scan_bwd_ref(*args, dy, ds)
        scales = scan_checks.bwd_row_scales(*args, dy, ds)
    assert [g.dtype for g in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype, torch.float32,
                                      torch.float32]
    errs = scan_checks.bwd_errors(got, ref, scales)
    assert scan_checks.bwd_within(errs, dtype), errs
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_selective_scan_grad_goes_through_the_backward_kernel(
        cuda, monkeypatch):
    """A CUDA call that needs a gradient launches the forward kernel once
    and the backward's kernels once each, never a plain version, and its
    gradients are the backward kernels' (dB and dC reach the projection
    B and C are views of)."""
    from repro_torch.kernels.mamba_scan import kernel_bwd as scan_bwd
    from repro_torch.kernels.mamba_scan import ref as scan_ref

    def plain(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((scan_ops, "selective_scan_ref"),
                      (scan_ref, "selective_scan_ref"),
                      (scan_ref, "selective_scan_bwd_ref")):
        monkeypatch.setattr(mod, name, plain)
    gen = torch.Generator(device="cuda").manual_seed(10)
    *args, dy, ds = scan_checks.bwd_inputs((2, 70, 256, 16), torch.bfloat16,
                                           gen, 1.0, 1.0)
    x, dt, A, B, C, D, h0 = args
    proj = B._base
    assert proj is not None and C._base is proj
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, dt, A, proj, D, h0)]
    n = A.shape[1]
    dtr = proj.shape[2] - 2 * n
    Bv, Cv = leaves[3][..., dtr:dtr + n], leaves[3][..., dtr + n:]
    before = (scan_ops.launches, scan_ops.launches_bwd,
              dict(scan_ops.launches_by_mode))
    # the backward reads the forward's checkpoints: it runs no forward of
    # its own for them
    real_checkpoints = scan_bwd.forward_checkpoints
    monkeypatch.setattr(scan_bwd, "forward_checkpoints", plain)
    y, h = scan_ops.selective_scan(*leaves[:3], Bv, Cv, *leaves[4:])
    grads = torch.autograd.grad((y, h), leaves, (dy, ds))
    assert (scan_ops.launches - before[0],
            scan_ops.launches_bwd - before[1]) == (1, len(scan_bwd.KERNELS))
    assert scan_bwd.KERNELS == ("bwd", "sum")
    assert {m: scan_ops.launches_by_mode[m] - before[2][m]
            for m in before[2]} == {"serving": 0, "training": 1}
    monkeypatch.setattr(scan_bwd, "forward_checkpoints", real_checkpoints)
    want = scan_bwd.selective_scan_bwd_cuda(x, dt, A, B, C, D, h0, dy, ds)
    gx, gdt, gA, gproj, gD, gh0 = grads
    for g, w in zip((gx, gdt, gA, gproj[..., dtr:dtr + n],
                     gproj[..., dtr + n:], gD, gh0), want):
        assert torch.equal(g, w)
    assert not gproj[..., :dtr].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,state_scale,dstate_scale,opts",
                         SCAN_BWD_CASES)
def test_selective_scan_training_mode_is_serving_bit_for_bit(
        cuda, shape, state_scale, dstate_scale, opts, dtype):
    """K3's forward in training mode: y and the final state bit for bit
    those of serving mode; its checkpoints bit for bit those of PR 24's
    "ckpt" kernel (the sweep library), and within the forward's
    elementwise state limit of the plain states before every 16th
    step."""
    from repro_torch.kernels.mamba_scan import kernel_bwd as scan_bwd
    from repro_torch.kernels.mamba_scan.ref import selective_scan_checkpoints
    gen = torch.Generator(device="cuda").manual_seed(12)
    *args, dy, ds = scan_checks.bwd_inputs(shape, dtype, gen, state_scale,
                                           dstate_scale, **opts)
    x, dt, A, B, C, D, h0 = args
    ck = torch.full(scan_bwd.checkpoint_shape(shape), float("nan"),
                    device="cuda")
    first = torch.full_like(ck, float("nan"))
    with torch.inference_mode():
        y0, s0 = scan_kernel.selective_scan_cuda(*args)
        y1, s1 = scan_kernel.selective_scan_cuda(*args, checkpoints=ck)
        scan_bwd.selective_scan_bwd_cuda(*args, dy, kernels=("ckpt",),
                                         checkpoints=first, design="first",
                                         sweep=True)
        want = selective_scan_checkpoints(x, dt, A, B, h0, 16)
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    assert torch.equal(ck, first)
    n = shape[3]
    assert not ck[..., n:].any()
    scale = want.pow(2).mean().sqrt().item()
    torch.testing.assert_close(ck[..., :n], want,
                               rtol=scan_checks.STATE_TOL,
                               atol=scan_checks.STATE_TOL * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,state_scale,dstate_scale,opts",
                         SCAN_BWD_CASES)
def test_selective_scan_bwd_design_matches_the_first(
        cuda, shape, state_scale, dstate_scale, opts, dtype):
    """The design's gradients against PR 24's form (the sweep library's
    "first": ckpt, bwd, sum) within checks.BWD_ROW_TOL of the plain
    backward's row scales; dA, dD and dh_0 bit for bit (the same terms
    summed in the same order)."""
    from repro_torch.kernels.mamba_scan import kernel_bwd as scan_bwd
    gen = torch.Generator(device="cuda").manual_seed(13)
    *args, dy, ds = scan_checks.bwd_inputs(shape, dtype, gen, state_scale,
                                           dstate_scale, **opts)
    got = scan_bwd.selective_scan_bwd_cuda(*args, dy, ds)
    first = scan_bwd.selective_scan_bwd_cuda(*args, dy, ds, design="first",
                                             sweep=True)
    with torch.no_grad():
        scales = scan_checks.bwd_row_scales(*args, dy, ds)
    assert scan_checks.bwd_within(scan_checks.bwd_errors(got, first, scales),
                                  dtype)
    for name in ("dA", "dD", "ds0"):
        i = scan_checks.GRADS.index(name)
        assert torch.equal(got[i], first[i]), name


def test_selective_scan_bwd_rejects_what_its_kernels_do_not_take(cuda):
    from repro_torch.kernels.mamba_scan import kernel_bwd as scan_bwd
    gen = torch.Generator(device="cuda").manual_seed(11)
    *args, dy, ds = scan_checks.bwd_inputs((1, 8, 16, 4), torch.float32,
                                           gen, 1.0, 1.0)
    with pytest.raises(ValueError, match="selective_scan_bwd takes"):
        scan_bwd.selective_scan_bwd_cuda(*args, dy.bfloat16(), ds)
    with pytest.raises(ValueError, match="selective_scan_bwd takes"):
        scan_bwd.selective_scan_bwd_cuda(*args, dy, ds[:, :, :2])
    bad = list(args)
    bad[2] = bad[2].t().contiguous().t()             # A not contiguous
    with pytest.raises(ValueError, match="selective_scan_bwd takes"):
        scan_bwd.selective_scan_bwd_cuda(*bad, dy, ds)
    with pytest.raises(ValueError, match="has kernels"):
        scan_bwd.selective_scan_bwd_cuda(*args, dy, ds, kernels=("dx",))


def test_jamba_loss_and_grads_on_the_card_match_cpu(cuda):
    """JambaLM.loss and its gradients in f32 on the card (K1's and K3's
    forward and backward kernels, each period remat'ed, the MoE's expert
    products) equal the CPU's (the plain versions under autograd): loss
    1e-4, each gradient leaf within 1e-3 of its largest |g|; K1 twice
    forward and once backward a period, K3 twice forward and once backward
    a Mamba layer."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.kernels.mamba_scan import kernel_bwd as scan_bwd
    from repro_torch.training.step import value_and_grad
    cfg = get_smoke("jamba-1.5-large-398b").replace(dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=rng)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = value_and_grad(model, params, batch)
    before = (ops.launches, ops.launches_bwd, scan_ops.launches,
              scan_ops.launches_bwd)
    got = value_and_grad(model, _to(params, cuda), _to(batch, cuda))
    p, m = model.n_periods, model.n_periods * model.n_mamba
    assert (ops.launches - before[0], ops.launches_bwd - before[1],
            scan_ops.launches - before[2],
            scan_ops.launches_bwd - before[3]) == (
        2 * p, len(kernel_bwd.KERNELS["general"]) * p, 2 * m,
        len(scan_bwd.KERNELS) * m)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    for (path, g), w in zip(T.flatten(got[2]), T.leaves(want[2])):
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-3 * w.abs().max().item(), path


def test_jamba_train_launcher_on_the_card(cuda):
    """The launcher's jamba-1.5-large-398b smoke run on the card: finite
    losses."""
    from repro_torch.launch import train as launch_train
    out = launch_train.run(get_smoke("jamba-1.5-large-398b"), steps=4,
                           batch=2, seq=64, device="cuda",
                           log=lambda *a: None)
    losses = [r["loss"] for r in out["records"]]
    assert len(losses) == 4 and all(map(math.isfinite, losses))


def test_moe_bf16_expert_products_differentiate_on_the_card(cuda):
    """A bf16 expert product that needs a gradient goes through the
    f32-output product (its forward the serving call's bits) and its
    gradients are ``bmm_f32_grads``' on the CPU within one bf16 ulp (the
    f32 sums in another order); a bf16 ``apply_moe``'s gradients on the
    card agree with the CPU's at the bf16 limit."""
    from repro_torch.models import moe as M
    gen = torch.Generator().manual_seed(5)
    a = torch.randn((4, 24, 64), generator=gen).bfloat16()
    w = (torch.randn((4, 64, 96), generator=gen) * 0.125).bfloat16()
    g = torch.randn((4, 24, 96), generator=gen)
    leaves = [a.to(cuda).requires_grad_(), w.to(cuda).requires_grad_()]
    out = M._bmm_f32(*leaves)
    with torch.no_grad():
        assert torch.equal(out, M._bmm_f32(*leaves))
    got = torch.autograd.grad(out, leaves, g.to(cuda))
    for x, y in zip(got, M.bmm_f32_grads(a, w, g)):
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x.float().cpu(), y.float(),
                                   rtol=2 ** -8,
                                   atol=2 ** -8 * y.float().abs().max().item())
    cfg = get_smoke("mixtral-8x7b")
    p = M.init_moe(torch.Generator().manual_seed(6), cfg, torch.bfloat16,
                   "cpu")
    x = torch.randn((2, 12, cfg.d_model), generator=gen).bfloat16()
    dy = torch.randn((2, 12, cfg.d_model), generator=gen).bfloat16()
    grads = []
    for dev in ("cpu", cuda):
        xs = x.to(dev).requires_grad_()
        ps = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        y, aux = M.apply_moe(xs, ps, cfg)
        grads.append([t.float().cpu() for t in torch.autograd.grad(
            (y, aux), [xs, *ps.values()], (dy.to(dev), torch.ones((),
                                                                   device=dev)))])
    for want, got in zip(*grads):
        torch.testing.assert_close(got, want, rtol=5e-2,
                                   atol=5e-2 * want.abs().max().item())


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


# ------------------------------------------------ K1's backward, training

# (b, sq, skv, h, hd), causal, window, softcap, layout; each in f32 and
# in bf16: hd 12 (minicpm smoke), 16, 64, 120 (danube) and 128, a window,
# a softcap, sq != skv without the causal mask, a (b, h, s, hd) storage
BWD_CASES = [
    ((2, 100, 100, 6, 12), True, 0, 0.0, "plain"),
    ((2, 130, 130, 4, 16), True, 16, 0.0, "strided"),
    ((1, 257, 257, 4, 64), True, 64, 0.0, "plain"),
    ((1, 64, 192, 2, 64), False, 0, 0.0, "plain"),
    ((2, 200, 200, 4, 128), True, 0, 0.0, "plain"),
    ((1, 300, 300, 2, 120), True, 100, 0.0, "plain"),
    ((1, 96, 96, 2, 64), True, 0, 30.0, "plain"),
    ((1, 1, 1, 1, 32), True, 0, 0.0, "plain"),
    # above hd 128: two warps a 16-row slice in bf16, 32-row tiles in f32
    ((2, 200, 200, 4, 256), True, 0, 0.0, "plain"),
    ((1, 150, 150, 2, 192), True, 40, 0.0, "strided"),
    ((1, 96, 160, 2, 200), False, 0, 30.0, "plain"),
]
@pytest.mark.parametrize("shape,causal,window,softcap,layout,dtype", [
    pytest.param(*case, dtype, id=f"bwd{i}-{name}")
    for i, case in enumerate(BWD_CASES)
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))])
def test_bwd_kernel_matches_plain(cuda, shape, causal, window, softcap,
                                  layout, dtype):
    """dq, dk, dv of each backward variant that takes the call (the
    general one always, the Hopper one where kernel_bwd.plan picks it,
    with the forward's LSE, and the general one again reading that LSE)
    against attention_bwd_ref on f32 copies,
    row by row at the forward's limits against each row's scale
    (checks.bwd_row_scales, as chip_smoke.py); two calls bit-identical.
    hd 120 in bf16: the Hopper forward and the general backward."""
    q, k, v = _qkv(*shape, dtype, layout=layout, seed=3)
    bf16, hd = dtype == torch.bfloat16, shape[4]
    assert kernel.plan(q, k, v) == (
        "hopper" if bf16 and (hd, hd) in kernel.HOPPER_HEAD_DIM_PAIRS
        else "general")
    assert kernel_bwd.plan(q, k, v) == (
        "hopper" if bf16 and hd in kernel_bwd.HOPPER_HEAD_DIMS
        else "general")
    do = torch.randn(q.shape, generator=torch.Generator(
        device="cuda").manual_seed(4), device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    # (variant, reads the forward's LSE): the general one always without
    # it, and where the forward writes one the general one and the route
    # plan picks with it
    variants = [("general", False)]
    with torch.no_grad():
        o = ops.flash_attention(q, k, v, **kw)
        lse = None
        if kernel.writes_lse(q, k, v):
            lse = kernel.lse_buffer(q)
            kernel.flash_attention_cuda(q, k, v, "hopper", lse=lse, **kw)
            variants.append(("general", True))
            if kernel_bwd.plan(q, k, v, o) == "hopper":
                variants.append(("hopper", True))
        f32 = [t.float() for t in (q, k, v, o, do)]
        ref = attention_bwd_ref(*f32, **kw)
        scales = flash_checks.bwd_row_scales(*f32, **kw)
        for variant, with_lse in variants:
            lv = lse if with_lse else None
            got = kernel_bwd.flash_attention_bwd_cuda(q, k, v, o, do,
                                                      variant, lse=lv, **kw)
            again = kernel_bwd.flash_attention_bwd_cuda(q, k, v, o, do,
                                                        variant, lse=lv,
                                                        **kw)
            for a, b, r, m, t in zip(got, again, ref, scales, (q, k, v)):
                assert a.shape == t.shape and a.dtype == dtype
                assert torch.equal(a, b)
                assert flash_checks.grad_row_err(a, r, m) <= ROW_TOL[dtype]


# (b, sq, skv, h, hd), causal, window, softcap, q/k scale: the Hopper
# backward's cases (bf16, hd 64, 128 and 256): a window with a softcap,
# sq != skv without the causal mask, sq not a multiple of a tile, skv > sq
# causal (kv tiles no q row sees), a tile of one row
HOPPER_BWD_CASES = [
    ((2, 512, 512, 8, 64), True, 256, 30.0, 6.0),
    ((2, 300, 500, 4, 128), False, 0, 0.0, 2.0),
    ((2, 1000, 1000, 4, 64), True, 0, 0.0, 2.0),
    ((1, 200, 456, 4, 128), True, 0, 0.0, 2.0),
    ((1, 1, 1, 2, 64), True, 0, 0.0, 2.0),
    # whisper-tiny's training step, none causal: the cross-attention and
    # the encoder
    ((16, 448, 1500, 6, 64), False, 0, 0.0, 2.0),
    ((16, 1500, 1500, 6, 64), False, 0, 0.0, 2.0),
    # hd 256 (gemma3-4b's training): 64-row units and streamed tiles, the
    # consumers splitting the gradients' columns; a ragged causal wave,
    # sq != skv without the causal mask, skv > sq causal, a last tile of
    # one row, a window that is no multiple of a tile, a softcap
    ((2, 333, 333, 4, 256), True, 0, 0.0, 2.0),
    ((1, 200, 333, 4, 256), False, 0, 0.0, 2.0),
    ((1, 200, 456, 4, 256), True, 0, 0.0, 2.0),
    ((1, 65, 65, 2, 256), True, 0, 0.0, 2.0),
    ((2, 700, 700, 2, 256), True, 257, 0.0, 2.0),
    ((1, 300, 300, 4, 256), True, 0, 30.0, 6.0),
]


@pytest.mark.parametrize("shape,causal,window,softcap,qk_scale",
                         HOPPER_BWD_CASES)
def test_hopper_bwd_matches_plain(cuda, shape, causal, window, softcap,
                                  qk_scale):
    """The Hopper backward through ops.flash_attention and autograd (its
    route, the forward's LSE, preprocess, dK/dV, dQ) against
    attention_bwd_ref, row by row; two calls bit-identical."""
    q, k, v = _qkv(*shape, torch.bfloat16, seed=8)
    q, k = q * (qk_scale / 2), k * (qk_scale / 2)
    _hopper_bwd_matches_plain(q, k, v, dict(causal=causal, window=window,
                                            softcap=softcap))


@pytest.mark.parametrize("layout", ["gqa-view", "strided"])
def test_hopper_bwd_at_hd256_reads_views(cuda, layout):
    """The Hopper backward at hd 256 on the views TMA reads without a
    copy: one KV head seen as all 8 (stride-0 heads), and a (b, h, s, hd)
    storage; as test_hopper_bwd_matches_plain."""
    q, k, v = _qkv(2, 300, 300, 8, 256, torch.bfloat16,
                   layout="plain" if layout == "gqa-view" else layout,
                   seed=14)
    if layout == "gqa-view":
        k, v = (t[:, :, :1].expand(t.shape) for t in (k, v))
    _hopper_bwd_matches_plain(q, k, v, dict(causal=True, window=0,
                                            softcap=0.0))


def _hopper_bwd_matches_plain(q, k, v, kw):
    """The Hopper backward through ops.flash_attention and autograd
    against attention_bwd_ref, row by row; two calls bit-identical."""
    do = torch.randn(q.shape, generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda").bfloat16()
    assert kernel_bwd.plan(q, k, v) == "hopper"

    def grads():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = ops.flash_attention(qq, kk, vv, **kw)
        return o.detach(), torch.autograd.grad(o, (qq, kk, vv), do)

    before = ops.launches_bwd_by_variant["hopper"]
    o, got = grads()
    again = grads()[1]
    assert ops.launches_bwd_by_variant["hopper"] - before == 6
    f32 = [t.float() for t in (q, k, v, o, do)]
    ref = attention_bwd_ref(*f32, **kw)
    scales = flash_checks.bwd_row_scales(*f32, **kw)
    for a, b, r, m in zip(got, again, ref, scales):
        assert torch.equal(a, b)
        assert flash_checks.grad_row_err(a, r, m) <= ROW_TOL[torch.bfloat16]


# the forward's training mode at hd 256 (Hd256Tile), whose LSE the
# backward reads: a ragged wave, a softcap, a window that is no
# multiple of a kv tile, sq != skv without the causal mask
LSE_HD256_CASES = [
    ((2, 333, 333, 4, 256), True, 0, 0.0, 2.0),
    ((1, 300, 300, 4, 256), True, 0, 30.0, 6.0),
    ((2, 700, 700, 2, 256), True, 257, 0.0, 2.0),
    ((1, 200, 333, 4, 256), False, 0, 0.0, 2.0),
]


@pytest.mark.parametrize("shape,causal,window,softcap,qk_scale",
                         HOPPER_BWD_CASES + LSE_HD256_CASES)
def test_forward_lse_matches_the_stats_kernel(cuda, shape, causal, window,
                                              softcap, qk_scale):
    """The forward's training-mode LSE against the general backward's
    stats kernel's (which recomputes it), within 1e-5 relative, and the
    training mode's o is the serving instantiation's, bit for bit."""
    q, k, v = _qkv(*shape, torch.bfloat16, seed=10)
    q, k = q * (qk_scale / 2), k * (qk_scale / 2)
    kw = dict(causal=causal, window=window, softcap=softcap)
    lse = kernel.lse_buffer(q)
    with torch.no_grad():
        o = kernel.flash_attention_cuda(q, k, v, "hopper", lse=lse, **kw)
        assert torch.equal(o, kernel.flash_attention_cuda(q, k, v, "hopper",
                                                          **kw))
        stats = kernel_bwd.launch(q, k, v, o, torch.zeros_like(o), "general",
                                  kernels=("stats",), **kw)[3]
    got = lse[..., :shape[1]]
    torch.testing.assert_close(got, stats, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,causal,window,softcap,qk_scale",
                         LSE_HD256_CASES)
@pytest.mark.parametrize("gqa", [False, True])
def test_forward_lse_at_hd256_matches_plain(cuda, shape, causal, window,
                                            softcap, qk_scale, gqa):
    """The Hopper forward's LSE at hd 256 (k and v contiguous, or one KV
    head seen as all of q's) against attention_lse on the same bf16
    inputs, within 2e-5 + 2e-5 |lse| (f32 statistics; the products are
    exact on both sides, only their sums' order differs); its rows past
    sq stay unwritten."""
    q, k, v = _qkv(*shape, torch.bfloat16, seed=13)
    q, k = q * (qk_scale / 2), k * (qk_scale / 2)
    if gqa:
        k, v = (t[:, :, :1].expand(t.shape) for t in (k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    assert kernel.plan(q, k, v) == "hopper" and kernel.writes_lse(q, k, v)
    lse = kernel.lse_buffer(q).fill_(7.0)
    with torch.no_grad():
        kernel.flash_attention_cuda(q, k, v, "hopper", lse=lse, **kw)
        want = ref_lse(q, k, **kw)
    torch.testing.assert_close(lse[..., :shape[1]], want, rtol=2e-5,
                               atol=2e-5)
    assert (lse[..., shape[1]:] == 7.0).all()


def test_hd256_gradient_reads_the_forward_lse(cuda):
    """A bf16 call at hd 256 that needs a gradient: the forward on the
    Hopper variant in training mode (the LSE saved), the backward on the
    Hopper route's three kernels reading that LSE (counted under
    "forward", none recomputed), its gradients those of
    attention_bwd_ref row by row, and the same bits as the Hopper
    backward handed the same LSE directly; the general backward handed
    it, its yardstick, within the same limits."""
    q, k, v = (t.requires_grad_() for t in _qkv(2, 300, 300, 4, 256,
                                                 torch.bfloat16, seed=14))
    kw = dict(causal=True, window=100, softcap=0.0)
    fwd = dict(ops.launches_by_variant)
    bwd = dict(ops.launches_bwd_by_variant)
    by_lse = dict(ops.bwd_calls_by_lse)
    o = ops.flash_attention(q, k, v, **kw)
    assert o.grad_fn.route == "hopper"
    lse = o.grad_fn.saved_tensors[4]
    do = torch.randn_like(o)
    got = torch.autograd.grad(o, (q, k, v), do)
    assert ops.launches_by_variant == {**fwd, "hopper": fwd["hopper"] + 1}
    assert ops.launches_bwd_by_variant == {
        **bwd, "hopper": bwd["hopper"] + len(kernel_bwd.KERNELS["hopper"])}
    assert ops.bwd_calls_by_lse == {**by_lse,
                                    "forward": by_lse["forward"] + 1}
    qd, kd, vd, od = (t.detach() for t in (q, k, v, o))
    want = kernel_bwd.flash_attention_bwd_cuda(qd, kd, vd, od, do,
                                               "hopper", lse=lse, **kw)
    general = kernel_bwd.flash_attention_bwd_cuda(qd, kd, vd, od, do,
                                                  "general", lse=lse, **kw)
    f32 = [t.float() for t in (qd, kd, vd, od, do)]
    ref = attention_bwd_ref(*f32, **kw)
    scales = flash_checks.bwd_row_scales(*f32, **kw)
    for a, w, y, r, m in zip(got, want, general, ref, scales):
        assert torch.equal(a, w)
        assert flash_checks.grad_row_err(a, r, m) <= ROW_TOL[torch.bfloat16]
        assert flash_checks.grad_row_err(y, r, m) <= ROW_TOL[torch.bfloat16]


def test_general_bwd_takes_a_forward_lse_in_bf16_only(cuda):
    """The general backward refuses a forward's LSE in f32 (its stats
    kernel has no D-only form there) or not from lse_buffer, before any
    launch."""
    q, k, v = _qkv(1, 64, 64, 2, 256, torch.float32)
    o = attention_ref(q, k, v)
    with pytest.raises(ValueError, match="bf16 only"):
        kernel_bwd.flash_attention_bwd_cuda(q, k, v, o, o, "general",
                                            lse=kernel.lse_buffer(q))
    qb, kb, vb, ob = (t.bfloat16() for t in (q, k, v, o))
    with pytest.raises(ValueError, match="bf16 only"):
        kernel_bwd.flash_attention_bwd_cuda(
            qb, kb, vb, ob, ob, "general",
            lse=torch.empty((1, 2, 64), device="cuda"))


def test_hopper_bwd_copies_a_dout_tma_refuses(cuda):
    """A dO whose head dim has stride 2 stays on the Hopper route: it is
    copied, the copy counted, and the gradients are those of the copy."""
    q, k, v = (t.requires_grad_() for t in _qkv(1, 130, 130, 2, 64,
                                                 torch.bfloat16, seed=11))
    o = ops.flash_attention(q, k, v)
    wide = torch.randn((1, 130, 2, 128), device="cuda").bfloat16()
    copies = ops.bwd_dout_copies
    before = ops.launches_bwd_by_variant["hopper"]
    o.backward(wide[..., ::2])
    assert ops.bwd_dout_copies == copies + 1
    assert ops.launches_bwd_by_variant["hopper"] - before == 3


def test_hd120_gradient_takes_hopper_forward_general_backward(cuda):
    """A call at hd 120 that needs a gradient runs: the forward on the
    Hopper variant (serving instantiation, no LSE), the backward on the
    general variant's three kernels, its gradients those of
    attention_bwd_ref row by row."""
    q, k, v = (t.requires_grad_() for t in _qkv(2, 300, 300, 4, 120,
                                                 torch.bfloat16, seed=12))
    kw = dict(causal=True, window=100, softcap=0.0)
    fwd = dict(ops.launches_by_variant)
    bwd = dict(ops.launches_bwd_by_variant)
    o = ops.flash_attention(q, k, v, **kw)
    assert o.grad_fn.route == "general"
    assert len(o.grad_fn.saved_tensors) == 4        # no LSE saved
    do = torch.randn_like(o)
    got = torch.autograd.grad(o, (q, k, v), do)
    assert ops.launches_by_variant == {**fwd, "hopper": fwd["hopper"] + 1}
    assert ops.launches_bwd_by_variant == {
        **bwd, "general": bwd["general"] + len(kernel_bwd.KERNELS["general"])}
    f32 = [t.detach().float() for t in (q, k, v, o, do)]
    ref = attention_bwd_ref(*f32, **kw)
    scales = flash_checks.bwd_row_scales(*f32, **kw)
    for a, r, m in zip(got, ref, scales):
        assert flash_checks.grad_row_err(a, r, m) <= ROW_TOL[torch.bfloat16]


def test_autograd_uses_the_backward_kernel(cuda):
    """Through ops.flash_attention with gradients: the Function launches
    the forward kernel once (training mode, the LSE written) and the
    Hopper backward's three kernels once each, and q/k/v's grads are the
    backward kernels'."""
    q, k, v = (t.requires_grad_() for t in _qkv(2, 150, 150, 4, 64,
                                                 torch.bfloat16, seed=5))
    before = (ops.launches, ops.launches_bwd)
    o = ops.flash_attention(q, k, v)
    do = torch.randn_like(o)
    o.backward(do)
    assert (ops.launches, ops.launches_bwd) == (
        before[0] + 1, before[1] + len(kernel_bwd.KERNELS["hopper"]))
    lse = kernel.lse_buffer(q)
    with torch.no_grad():
        kernel.flash_attention_cuda(q, k, v, "hopper", lse=lse)
    want = kernel_bwd.flash_attention_bwd_cuda(
        q.detach(), k.detach(), v.detach(), o.detach(), do, "hopper",
        lse=lse)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)


@pytest.mark.parametrize("arch", ["minicpm-2b", "mistral-nemo-12b",
                                  "h2o-danube-3-4b"])
def test_loss_and_grads_on_the_card_match_cpu(cuda, arch):
    """DecoderLM.loss and its gradients in f32 on the card (K1 forward and
    backward kernels, remat) equal the CPU's (plain attention): loss 1e-4,
    each gradient leaf within 1e-3 of its largest |g| (every product and
    reduction sums in another order)."""
    from repro_torch.training.step import value_and_grad
    cfg = get_smoke(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=rng)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = value_and_grad(model, params, batch)
    before = (ops.launches, ops.launches_bwd)
    got = value_and_grad(model, _to(params, cuda), _to(batch, cuda))
    n = cfg.n_layers
    assert (ops.launches - before[0], ops.launches_bwd - before[1]) == (
        2 * n, len(kernel_bwd.KERNELS["general"]) * n)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    from repro_torch import tree as T
    for (path, g), w in zip(T.flatten(got[2]), T.leaves(want[2])):
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-3 * w.abs().max().item(), path


def test_train_launcher_on_the_card(cuda):
    """The launcher's smoke run on the card: finite losses that fall."""
    from repro_torch.launch import train as launch_train
    out = launch_train.run(get_smoke("minicpm-2b"), steps=12, batch=4,
                           seq=64, device="cuda", log=lambda *a: None)
    losses = [r["loss"] for r in out["records"]]
    assert len(losses) == 12 and all(map(math.isfinite, losses))
    assert min(losses[-3:]) < max(losses[:3])


# --------------------------------------------------- MLA (DeepSeek-V3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k1_at_mla_head_dim_with_zero_padded_v(cuda, dtype):
    """K1 at MLA's head dim 192 (128 nope + 64 rope) with v's columns
    128..191 zero, as ``mla_prefill`` pads them: the general variant,
    held to attention_ref elementwise and by row, and the output's padded
    columns exactly zero."""
    q, k, v = _qkv(2, 300, 300, 8, 192, dtype)
    v[..., 128:] = 0
    assert kernel.plan(q, k, v) == "general"
    before = ops.launches_by_variant["general"]
    with torch.inference_mode():
        out = ops.flash_attention(q, k, v, causal=True)
        ref = attention_ref(q, k, v, causal=True)
    assert ops.launches_by_variant["general"] == before + 1
    assert torch.equal(out[..., 128:], torch.zeros_like(out[..., 128:]))
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    row = ((out.float() - ref.float()).norm(dim=-1)
           / ref.float().norm(dim=-1).clamp_min(1e-30))
    assert row.max().item() <= ROW_TOL[dtype]


# (b, sq, skv, h), causal, softcap, layout (``_qkv``) of K1's Hopper
# variant at MLA's head dims, q and k 192 columns and v 128, bf16: a
# ragged length, sq != skv without the causal mask, a (b, h, s, hd)
# storage, q and k the two halves of one storage, a softcap
MLA_CASES = [
    ((1, 1000, 1000, 8), True, 0.0, "plain"),
    ((1, 200, 333, 4), False, 0.0, "plain"),
    ((1, 300, 300, 4), True, 0.0, "strided"),
    ((2, 500, 500, 4), True, 0.0, "qk-halves"),
    ((1, 300, 300, 4), True, 30.0, "plain"),
    # a mesh rank's local heads: DeepSeek-V3's 64 of 128 on model = 2
    ((2, 1024, 1024, 64), True, 0.0, "plain"),
]


@pytest.mark.parametrize("shape,causal,softcap,layout", MLA_CASES)
def test_hopper_at_mla_head_dims_matches_plain(cuda, shape, causal, softcap,
                                               layout):
    """The Hopper variant at (192, 128) through the dispatcher against
    attention_ref (the function of v zero-padded to 192, o's first 128
    columns), elementwise and by row; two calls bit-identical."""
    q, k, v = _qkv(*shape, 192, torch.bfloat16, layout=layout, dv=128)
    kw = dict(causal=causal, softcap=softcap)
    assert kernel.plan(q, k, v) == "hopper"
    before = ops.launches_by_variant["hopper"]
    with torch.inference_mode():
        out = ops.flash_attention(q, k, v, **kw)
        again = ops.flash_attention(q, k, v, **kw)
        ref = attention_ref(q, k, v, **kw)
    assert ops.launches_by_variant["hopper"] == before + 2
    b, sq, _, h = shape
    assert out.shape == (b, sq, h, 128) and out.dtype == torch.bfloat16
    assert torch.equal(out, again)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    row = ((out.float() - ref.float()).norm(dim=-1)
           / ref.float().norm(dim=-1).clamp_min(1e-30))
    assert row.max().item() <= ROW_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,dv", [(192, 128), (24, 16)])
def test_general_with_narrower_v_equals_padded_v(cuda, hd, dv, dtype):
    """The general variant with v at dv < hd columns gives, bit for bit,
    the first dv columns of its output on v zero-padded to hd (it loads
    the missing columns as zeros), and holds to attention_ref."""
    q, k, v = _qkv(2, 300, 300, 8, hd, dtype, dv=dv)
    vp = torch.nn.functional.pad(v, (0, hd - dv))
    with torch.inference_mode():
        out = kernel.flash_attention_cuda(q, k, v, "general")
        padded = kernel.flash_attention_cuda(q, k, vp, "general")
        ref = attention_ref(q, k, v)
    assert out.shape == (2, 300, 8, dv)
    assert torch.equal(out, padded[..., :dv])
    assert not padded[..., dv:].any()
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,dv", [(192, 128), (256, 200), (120, 64),
                                   (24, 16)])
def test_bwd_with_narrower_v_matches_plain(cuda, hd, dv, dtype):
    """The general backward takes v, o and dO at dv < hd columns as they
    are (MLA's (192, 128) on its own instantiation, the rest with v's
    columns zero-filled in shared memory): dq, dk, dv against
    attention_bwd_ref row by row, dv at its dv columns; two calls
    bit-identical.  Through ops, the forward keeps kernel.plan's variant
    (the Hopper MlaTile at (192, 128) in bf16) and v is not padded."""
    q, k, v = _qkv(2, 300, 300, 4, hd, dtype, seed=14, dv=dv)
    do = torch.randn((2, 300, 4, dv), generator=torch.Generator(
        device="cuda").manual_seed(15), device="cuda").to(dtype)
    with torch.no_grad():
        o = ops.flash_attention(q, k, v)
        f32 = [t.float() for t in (q, k, v, o, do)]
        ref = attention_bwd_ref(*f32)
        scales = flash_checks.bwd_row_scales(*f32)
        got = kernel_bwd.flash_attention_bwd_cuda(q, k, v, o, do, "general")
        again = kernel_bwd.flash_attention_bwd_cuda(q, k, v, o, do,
                                                    "general")
    for a, b, r, m, t in zip(got, again, ref, scales, (q, k, v)):
        assert a.shape == t.shape and torch.equal(a, b)
        assert flash_checks.grad_row_err(a, r, m) <= ROW_TOL[dtype]
    fwd = dict(ops.launches_by_variant)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves)
    assert out.grad_fn.route == "general"
    assert ops.launches_by_variant == {
        **fwd, kernel.plan(q, k, v): fwd[kernel.plan(q, k, v)] + 1}
    assert torch.equal(out.detach(), o)
    grads = torch.autograd.grad(out, leaves, do)
    for a, b in zip(grads, got):
        assert torch.equal(a, b)


def test_mla_prefill_decode_on_the_card_match_cpu(cuda):
    """deepseek-v3-671b's smoke config in f32: prefill runs K1 once a
    layer (the general variant: hd 24), and its logits and latent caches,
    then 3 decode steps' (absorbed MLA, plain torch), equal the same
    model's on the CPU within 1e-4."""
    cfg = get_smoke("deepseek-v3-671b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    on_card = _to(params, cuda)
    with torch.inference_mode():
        want, want_cache, n = model.prefill(params, tokens, 48)
        before = ops.launches_by_variant["general"]
        got, got_cache, length = model.prefill(on_card, tokens.to(cuda), 48)
        torch.cuda.synchronize()
        assert ops.launches_by_variant["general"] == before + cfg.n_layers
        assert length == n == 40
        for step in range(3):
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
            for key in ("ckv", "krope"):
                torch.testing.assert_close(got_cache[key].cpu(),
                                           want_cache[key], rtol=1e-4,
                                           atol=1e-4)
            nxt = want[:, -1].argmax(-1, keepdim=True)
            want, want_cache, n = model.decode(params, want_cache, nxt, n)
            got, got_cache, length = model.decode(on_card, got_cache,
                                                  nxt.to(cuda), length)
        assert length == n == 43


def test_mla_loss_with_mtp_on_the_card_matches_cpu(cuda):
    """deepseek-v3-671b's smoke config in f32: ``loss`` with MTP and its
    gradients on the card (K1 forward and backward at hd 24: twice a layer
    under remat and once for the MTP layer, each with its backward) equal
    the CPU's: loss and the MTP loss 1e-4, each gradient leaf (mtp/*
    included) within 1e-3 of its largest |g|."""
    from repro_torch import tree as T
    from repro_torch.training.step import value_and_grad
    cfg = get_smoke("deepseek-v3-671b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = value_and_grad(model, params, batch)
    before = (ops.launches, ops.launches_bwd)
    got = value_and_grad(model, _to(params, cuda), _to(batch, cuda))
    n = cfg.n_layers
    assert (ops.launches - before[0], ops.launches_bwd - before[1]) == (
        2 * n + 1, len(kernel_bwd.KERNELS["general"]) * (n + 1))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1]["mtp"].cpu(), want[1]["mtp"],
                               rtol=1e-4, atol=1e-4)
    paths = [p for p, _ in T.flatten(got[2])]
    assert "mtp/layer/attn/wq_a" in paths
    for (path, g), w in zip(T.flatten(got[2]), T.leaves(want[2])):
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-3 * w.abs().max().item(), path


def test_remat_dots_saves_the_f32_expert_products_on_the_card(cuda,
                                                              monkeypatch):
    """mixtral-8x7b's smoke config in bf16 on the card: remat policy
    "dots" saves the MoE's f32-output expert products (``aten.bmm.dtype``)
    and gives the loss and gradients of no remat, bit for bit."""
    from repro_torch import tree as T
    from repro_torch.models import transformer as tT
    from repro_torch.training.step import value_and_grad
    cfg = get_smoke("mixtral-8x7b")
    model = build_model(cfg)
    params = _to(model.init(torch.Generator().manual_seed(0), "cpu"), cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 25),
                         generator=torch.Generator().manual_seed(1))
    batch = _to({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, cuda)

    class NoRemat(type(model)):
        def _run_layers(self, *a, remat=False):
            return super()._run_layers(*a, remat=False)

    loss0, _, grads0 = value_and_grad(NoRemat(cfg), params, batch)
    saved = []
    real = tT._save_dots

    def save_dots(ctx, op, *a, **kw):
        out = real(ctx, op, *a, **kw)
        if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return out

    monkeypatch.setattr(tT, "_save_dots", save_dots)
    model.remat_policy = "dots"
    loss, _, grads = value_and_grad(model, params, batch)
    assert torch.ops.aten.bmm.dtype in saved
    assert torch.equal(loss, loss0)
    for (path, g), g0 in zip(T.flatten(grads), T.leaves(grads0)):
        assert torch.equal(g, g0), path


# --------------------------------------------------------------- Whisper


def _whisper_inputs(cfg, b=2, s=40, frames=16):
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (b, s + 4), generator=gen)
    fr = torch.randn((b, frames, cfg.d_model), generator=gen)
    return toks, fr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_prefill_decode_on_the_card_match_cpu(cuda, dtype):
    """whisper-tiny's smoke config: prefill with 16 frames runs K1 once an
    encoder layer and twice a decoder layer (the general variant: hd 16),
    and its logits and four caches, then 4 teacher-forced decode steps'
    logits (plain torch), equal the same model's on the CPU with the same
    weights: f32 within 1e-4 (every product sums in another order), bf16
    within 5e-2."""
    cfg = get_smoke("whisper-tiny").replace(dtype=dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks, fr = _whisper_inputs(cfg)
    tol = 1e-4 if dtype == "float32" else 5e-2
    on_card = _to(params, cuda)
    with torch.inference_mode():
        want, want_cache, n = model.prefill(params, toks[:, :40], 48,
                                            frames=fr)
        before = ops.launches_by_variant["general"]
        got, got_cache, length = model.prefill(
            on_card, toks[:, :40].to(cuda), 48, frames=fr.to(cuda))
        torch.cuda.synchronize()
        assert ops.launches_by_variant["general"] == (
            before + cfg.n_enc_layers + 2 * cfg.n_layers)
        assert length == n == 40
        for key in ("k", "v", "ck", "cv"):
            torch.testing.assert_close(got_cache[key].cpu().float(),
                                       want_cache[key].float(), rtol=tol,
                                       atol=tol)
        for i in range(40, 44):
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       rtol=tol, atol=tol)
            want, want_cache, n = model.decode(params, want_cache,
                                               toks[:, i:i + 1], n)
            got, got_cache, length = model.decode(
                on_card, got_cache, toks[:, i:i + 1].to(cuda), length)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)
        assert length == n == 44


def test_whisper_train_step_on_the_card(cuda):
    """whisper-tiny's smoke config in bf16 on the card: ``loss`` and every
    gradient finite, K1's forward once an encoder layer and twice a
    decoder layer's attention (remat), its backward once an attention;
    then a train step (AdamW, cosine) with a finite loss."""
    from repro_torch import tree as T
    from repro_torch.launch.train import schedule_for
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.training.step import make_train_step, value_and_grad
    cfg = get_smoke("whisper-tiny")
    model = build_model(cfg)
    params = _to(model.init(torch.Generator().manual_seed(0), "cpu"), cuda)
    toks, fr = _whisper_inputs(cfg, s=32)
    batch = _to({"tokens": toks[:, :32], "labels": toks[:, 1:33],
                 "frames": fr}, cuda)
    before = (ops.launches, ops.launches_bwd)
    loss, metrics, grads = value_and_grad(model, params, batch)
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
    assert (ops.launches - before[0], ops.launches_bwd - before[1]) == (
        n_enc + 4 * n_dec,
        len(kernel_bwd.KERNELS["general"]) * (n_enc + 2 * n_dec))
    assert math.isfinite(loss.item()) and metrics["aux_loss"].item() == 0
    for path, g in T.flatten(grads):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all(), path
    opt = AdamW(schedule_for(cfg, 3), AdamWConfig(weight_decay=0.01))
    step = make_train_step(model, opt)
    params, state, m = step(params, opt.init(params), batch)
    assert math.isfinite(float(m["loss"]))


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("mesh,backend", [((2, 2), "gloo"),
                                          ((1, 1), "nccl")],
                         ids=["2x2-gloo", "1x1-nccl"])
def test_mesh_serving_on_the_card_matches_one_device(cuda, tmp_path, mesh,
                                                     backend):
    """DecoderLM's mesh path on the card (tests/torch_mesh_ranks.py, every
    rank on card 0: gloo with its collectives staged through host memory,
    or NCCL with one rank) against the same model on one device, on the
    card: mistral-nemo-12b's smoke config with ``sp_decode``, and
    DeepSeek-V3's with ``sp_decode`` and ``moe_full_ep`` (f32: 1e-4, as
    the card-vs-CPU tests, since the ranks sum their partial products in
    another order)."""
    import torch_mesh_ranks as ranks
    cases, want = {}, {}
    gen = torch.Generator().manual_seed(1)
    for arch, knobs in (("mistral-nemo-12b", {"sp_decode": True}),
                        ("deepseek-v3-671b", {"sp_decode": True,
                                              "moe_full_ep": True})):
        cfg = get_smoke(arch).replace(dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(1, cfg.vocab_size, (4, 12), generator=gen)
        forced = torch.randint(1, cfg.vocab_size, (4, 4), generator=gen)
        on_card = _to(params, cuda)
        with torch.inference_mode():
            logits, cache, n = model.prefill(on_card, toks.to(cuda), 24)
            rows = [logits]
            for i in range(4):
                logits, cache, n = model.decode(
                    on_card, cache, forced[:, i:i + 1].to(cuda), n)
                rows.append(logits)
        want[arch] = torch.cat(rows, dim=1).cpu()
        cases[arch] = {"kind": "decoder", "arch": arch, "dtype": "float32",
                       "moe": {}, "knobs": knobs, "params": params,
                       "tokens": toks, "forced": forced, "max_len": 24}
    outs = ranks.spawn(cases, mesh, tmp_path, device="cuda",
                       backend=backend)
    for arch in cases:
        torch.testing.assert_close(ranks.by_rows(outs, arch, mesh),
                                   want[arch], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,moe", [
    ("mistral-nemo-12b", {}),
    # no drops and no aux loss: the mesh takes both on each `data` shard
    ("deepseek-v3-671b", {"capacity_factor": 16.0, "aux_loss_coef": 0.0})],
    ids=["mistral", "deepseek"])
@pytest.mark.parametrize("mesh,backend", [((2, 2), "gloo"),
                                          ((1, 1), "nccl")],
                         ids=["2x2-gloo", "1x1-nccl"])
def test_mesh_training_on_the_card_matches_one_device(cuda, tmp_path, mesh,
                                                      backend, arch, moe):
    """DecoderLM.loss and every gradient leaf on a mesh of ranks on card 0
    (FSDP and TP blocks, tests/torch_mesh_ranks.py's "train_loss" case:
    the gradients summed over `data` and gathered whole) against the same
    model's ``value_and_grad`` on one device on the card: mistral-nemo-12b's
    smoke config and DeepSeek-V3's (MLA, MoE, MTP) in f32, a loss mask;
    the loss within 2e-5 relative, each leaf within 1e-4 of its largest
    |entry| (the CPU tests' limits)."""
    import dataclasses

    import torch_mesh_ranks as ranks
    from repro_torch import tree as T
    from repro_torch.training.step import value_and_grad
    cfg = get_smoke(arch).replace(dtype="float32")
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 17), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": (torch.rand((4, 16), generator=gen) < 0.7).float()}
    loss, _, grads = value_and_grad(model, _to(params, cuda),
                                    _to(batch, cuda))
    case = {"kind": "train_loss", "arch": arch, "dtype": "float32",
            "moe": moe, "knobs": {}, "params": params, "batch": batch}
    outs = ranks.spawn({"loss": case}, mesh, tmp_path, device="cuda",
                       backend=backend)
    for c, o in outs.items():
        got = o["loss"]
        torch.testing.assert_close(got["loss"], loss.cpu(), rtol=2e-5,
                                   atol=0)
        for path, g in T.flatten(grads):
            want = g.cpu()
            err = (got[f"g/{path}"] - want).abs().max().item()
            assert err <= 1e-4 * want.abs().max().item(), (c, path, err)
