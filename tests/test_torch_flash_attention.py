"""The PyTorch port's flash attention on the CPU: its plain version (the
one its dispatcher takes for CPU tensors, and the one the CUDA kernel is
held against on the card) against the reference Pallas kernel run in
interpret mode, against the reference oracle, and the port's blockwise
model twin against the reference's; and ``kernel.plan``, which picks the
CUDA kernel's variant from shapes, strides and dtype, on meta tensors.
The CUDA kernel itself runs only on the card (chip_smoke.py,
tests/test_torch_gpu.py)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def qkv(shape_q, skv=None, dtype="float32", seed=0):
    """The same uniform(-1, 1) q/k/v as JAX arrays and torch tensors."""
    b, sq, h, hd = shape_q
    skv = sq if skv is None else skv
    rng = np.random.default_rng(seed)
    arrs = [rng.uniform(-1, 1, s).astype(np.float32)
            for s in (shape_q, (b, skv, h, hd), (b, skv, h, hd))]
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **TOL[dtype])


# the reference kernel tests' grid (tests/test_kernels.py), plus head
# dims 12 (minicpm) and 256 (gemma3)
GRID = [
    (1, 64, 2, 64, True, 0),
    (2, 100, 3, 32, True, 16),
    (1, 128, 2, 128, False, 0),
    (1, 257, 1, 64, True, 64),
    (2, 48, 4, 16, True, 0),
    (2, 100, 6, 12, True, 0),
    (1, 96, 2, 256, True, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hd,causal,window", GRID)
def test_plain_matches_pallas_kernel(b, s, h, hd, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = qkv((b, s, h, hd), dtype=dtype)
    ref = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                 block_q=64, block_k=64, interpret=True)
    out = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == TDT[dtype] and out.shape == (b, s, h, hd)
    close(ref, out, dtype)
    close(jax_ref(jq, jk, jv, causal=causal, window=window), out, dtype)


@pytest.mark.parametrize("hd", [32, 256])
def test_plain_softcap(hd):
    (jq, jk, jv), (tq, tk, tv) = qkv((1, 96, 2, hd), seed=1)
    ref = flash_attention_pallas(jq, jk, jv, causal=True, softcap=30.0,
                                 block_q=32, block_k=32, interpret=True)
    close(ref, attention_ref(tq, tk, tv, causal=True, softcap=30.0),
          "float32")


def test_plain_ragged_noncausal():
    """sq != skv: the causal mask is not involved, the pad mask is."""
    (jq, jk, jv), (tq, tk, tv) = qkv((1, 64, 2, 32), skv=192, seed=2)
    ref = flash_attention_pallas(jq, jk, jv, causal=False, block_q=64,
                                 block_k=64, interpret=True)
    close(ref, tops.flash_attention(tq, tk, tv, causal=False), "float32")


@pytest.mark.parametrize("causal,window,softcap,q_offset", [
    (True, 0, 0.0, 0), (True, 16, 0.0, 0), (True, 0, 20.0, 0),
    (True, 24, 0.0, 40), (False, 0, 0.0, 0),
])
def test_model_twin_matches_reference_twin(causal, window, softcap,
                                           q_offset):
    """repro_torch.models.attention.flash_attention (blockwise, with
    q_offset) against repro.models.attention.flash_attention."""
    (jq, jk, jv), (tq, tk, tv) = qkv((2, 40, 3, 16), skv=40 + q_offset,
                                     seed=3)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, block_kv=32)
    close(jA.flash_attention(jq, jk, jv, **kw),
          tA.flash_attention(tq, tk, tv, **kw), "float32")


@pytest.mark.parametrize("b,s,h,hd,causal,window", GRID[:4])
def test_dispatch_matches_reference_model_attention(b, s, h, hd, causal,
                                                    window):
    """What DecoderLM prefill calls (ops, q_offset 0, sq == skv) equals
    what the reference DecoderLM prefill calls."""
    (jq, jk, jv), (tq, tk, tv) = qkv((b, s, h, hd), seed=4)
    close(jA.flash_attention(jq, jk, jv, causal=causal, window=window),
          tops.flash_attention(tq, tk, tv, causal=causal, window=window),
          "float32")


def test_dispatch_counts_no_cpu_launches():
    before = tops.launches
    _, (tq, tk, tv) = qkv((1, 16, 1, 16))
    tops.flash_attention(tq, tk, tv)
    assert tops.launches == before


def test_dispatch_rejects_bad_shapes():
    _, (tq, tk, tv) = qkv((1, 16, 2, 16))
    with pytest.raises(ValueError, match="repeat GQA"):
        tops.flash_attention(tq, tk[:, :, :1], tv[:, :, :1])
    with pytest.raises(ValueError, match="empty"):
        tops.flash_attention(tq, tk[:, :0], tv[:, :0])


@pytest.mark.parametrize("causal", [True, False])
def test_dispatch_rejects_rows_without_a_key(causal):
    """A window with sq > skv + window - 1 leaves the last rows no key;
    one row fewer is accepted and agrees with the Pallas kernel."""
    (jq, jk, jv), (tq, tk, tv) = qkv((1, 24, 2, 16), skv=16, seed=5)
    with pytest.raises(ValueError, match="no key"):
        tops.flash_attention(tq, tk, tv, causal=causal, window=8)
    ref = flash_attention_pallas(jq[:, :23], jk, jv, causal=causal, window=8,
                                 block_q=8, block_k=8, interpret=True)
    out = tops.flash_attention(tq[:, :23], tk, tv, causal=causal, window=8)
    close(ref, out, "float32")


def test_cpu_grad_takes_plain_version():
    _, (tq, tk, tv) = qkv((1, 8, 1, 16))
    tq.requires_grad_(True)
    tops.flash_attention(tq, tk, tv).sum().backward()
    assert tq.grad is not None and torch.isfinite(tq.grad).all()


def test_build_is_keyed_by_source_and_lazy():
    """The library path changes with the source text; importing the
    module compiled and loaded nothing."""
    path = tK.library_path()
    assert path.parent.name.startswith("flash_attention-")
    assert path.parent.parent == tK.BUILD_ROOT
    assert tK.library.cache_info().currsize == 0
    assert "arch=compute_90a,code=sm_90a" in tK.NVCC_FLAGS


# ------------------------------------------------ kernel.plan (variants)


def meta(shape, strides=None, dtype=torch.bfloat16, offset=0):
    """A tensor with a shape and strides and no data, on no card."""
    if strides is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.empty_strided(shape, strides, dtype=dtype,
                               device="meta").as_strided(shape, strides,
                                                         offset)


@pytest.mark.parametrize("b,s,h", [
    (4, 1024, 32), (4, 916, 32), (1, 7, 32),       # mistral-nemo-12b
    (4, 1024, 64), (4, 365, 64),                   # the Jamba cut
])
def test_plan_main_path_shapes_pick_hopper(b, s, h):
    q = meta((b, s, h, 128))
    assert q.stride() == (s * h * 128, h * 128, 128, 1)
    assert tK.plan(q, meta((b, s, h, 128)), meta((b, s, h, 128))) == "hopper"


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "jamba-1.5-large-398b"])
def test_plan_of_the_models_own_qkv_is_hopper(arch):
    """q, k, v as DecoderLM/JambaLM prefill builds them at full width (the
    projections' reshape, RoPE where the model has it, the GQA repeat),
    on the meta device: the serving path's strides go to the Hopper
    variant."""
    cfg = get_config(arch)
    hd = cfg.resolved_head_dim
    d, nq, nkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    ap = {name: meta(shape) for name, shape in (
        ("wq", (d, nq * hd)), ("wk", (d, nkv * hd)), ("wv", (d, nkv * hd)))}
    x = meta((4, 916, d))
    q, k, v = tA.project_qkv(x, ap, cfg)
    if not cfg.no_rope:
        pos = torch.arange(916, device="meta")[None, :].expand(4, 916)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    k, v = tA.repeat_kv(k, nq), tA.repeat_kv(v, nq)
    assert q.shape == k.shape == v.shape == (4, 916, nq, hd)
    assert tK.plan(q, k, v) == "hopper"


@pytest.mark.parametrize("case", [
    "f32", "hd12", "hd16", "hd32", "hd256", "head-stride-not-16-bytes",
    "seq-stride-not-16-bytes", "base-not-16-bytes", "hd-stride-not-1",
    "f32-k",
])
def test_plan_picks_general_for_what_tma_or_wgmma_refuse(case):
    b, s, h, hd = 2, 64, 4, 128
    q = k = v = meta((b, s, h, hd))
    if case == "f32":
        q = k = v = meta((b, s, h, hd), dtype=torch.float32)
    elif case.startswith("hd"):
        if case == "hd-stride-not-1":
            q = meta((b, s, h, hd), (s * h * hd * 2, h * hd * 2, hd * 2, 2))
        else:
            n = int(case[2:])
            q = k = v = meta((b, s, h, n))
    elif case == "head-stride-not-16-bytes":      # 132 x 2 bytes a head
        q = meta((b, s, h, hd), (s * h * 132, h * 132, 132, 1))
    elif case == "seq-stride-not-16-bytes":
        k = meta((b, s, h, hd), (s * (h * hd + 4), h * hd + 4, hd, 1))
    elif case == "base-not-16-bytes":
        v = meta((b, s, h, hd), (s * h * hd, h * hd, hd, 1), offset=3)
    elif case == "f32-k":
        k = meta((b, s, h, hd), dtype=torch.float32)
    assert tK.plan(q, k, v) == "general"


def test_plan_takes_strided_views_tma_can_read():
    """(b, h, s, hd) storage seen as (b, s, h, hd): TMA reads it through
    its strides (checked on the card by chip_smoke.py's strided-hd128
    case), and hd 64 goes to the Hopper variant too."""
    b, s, h = 1, 300, 4
    for hd in (64, 128):
        t = meta((b, h, s, hd)).transpose(1, 2)
        assert t.stride() == (h * s * hd, hd, s * hd, 1)
        assert tK.plan(t, t, t) == "hopper"


def test_plan_mirrors_the_kernel_source():
    """The constants plan() uses are the ones the .cu compiles with."""
    src = tK.SOURCE.read_text()
    hopper = src[src.index("namespace hopper {"):]
    assert "constexpr int BQ = %d;" % tK.HOPPER_BQ in hopper
    assert "if (hd != 64 && hd != 128)" in hopper
    assert tK.HOPPER_HEAD_DIMS == (64, 128)
    assert set(tK.VARIANTS) == set(tops.launches_by_variant)


def test_cpu_calls_count_no_variant():
    before = dict(tops.launches_by_variant)
    _, (tq, tk, tv) = qkv((1, 16, 2, 64), dtype="bfloat16")
    tops.flash_attention(tq, tk, tv)
    assert tops.launches_by_variant == before


def test_cuda_call_needs_a_known_variant():
    _, (tq, tk, tv) = qkv((1, 16, 2, 64), dtype="bfloat16")
    with pytest.raises(ValueError, match="no flash attention variant"):
        tK.flash_attention_cuda(tq, tk, tv, "fastest")
    assert tK.library.cache_info().currsize == 0


# ------------------------------------------------ the backward (plain)

from jax import grad as jax_grad  # noqa: E402

from repro_torch.kernels.flash_attention import checks as tchecks  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_bwd as tKB  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_bwd_ref  # noqa: E402

# (b, sq, skv, h, hd), causal, window, softcap: the forward grid's kinds,
# a ragged sq != skv without the causal mask, hd 12 (minicpm smoke) and
# 120 (h2o-danube-3-4b)
BWD_GRID = [
    ((1, 64, 64, 2, 64), True, 0, 0.0),
    ((2, 100, 100, 3, 32), True, 16, 0.0),
    ((1, 96, 96, 2, 16), True, 0, 30.0),
    ((1, 48, 80, 2, 16), False, 0, 0.0),
    ((2, 70, 70, 2, 12), True, 0, 0.0),
    ((1, 130, 130, 1, 120), True, 64, 0.0),
]
BWD_TOL = dict(rtol=1e-5, atol=1e-5)   # f32, both sides f32 products


def bwd_inputs(shape, seed=2):
    """q, k, v, do ~ U(-1, 1) as f64 numpy, then f32 tensors."""
    b, sq, skv, h, hd = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.uniform(-1, 1, s).astype(np.float32) for s in
            ((b, sq, h, hd), (b, skv, h, hd), (b, skv, h, hd),
             (b, sq, h, hd))]
    return arrs, [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("shape,causal,window,softcap", BWD_GRID)
def test_bwd_ref_matches_autograd(shape, causal, window, softcap):
    """The explicit formula equals autograd through attention_ref."""
    _, (q, k, v, do) = bwd_inputs(shape)
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = attention_ref(q, k, v, **kw)
    o.backward(do)
    got = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                            do, **kw)
    for g, t in zip(got, (q, k, v)):
        torch.testing.assert_close(g, t.grad, **BWD_TOL)


@pytest.mark.parametrize("shape,causal,window,softcap",
                         [c for c in BWD_GRID if c[0][1] == c[0][2]])
def test_bwd_ref_matches_jax_grad_of_the_twin(shape, causal, window,
                                              softcap):
    """The gradient the reference trains through: jax.grad of the jnp
    twin (models/attention.py::flash_attention), contracted with the same
    dO; sq == skv, where the twin's causal alignment is K1's."""
    (jq, jk, jv, jdo), (q, k, v, do) = bwd_inputs(shape)
    kw = dict(causal=causal, window=window, softcap=softcap)

    def f(a, b, c):
        return jnp.sum(jA.flash_attention(a, b, c, block_kv=32, **kw) * jdo)

    want = jax_grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (jq, jk, jv)))
    o = attention_ref(q, k, v, **kw)
    got = attention_bwd_ref(q, k, v, o, do, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)


def test_bwd_faults_exceed_the_limits():
    """Each fault chip_smoke.py holds the kernel against moves the
    gradient far past the f32 limit."""
    shape = (1, 160, 160, 2, 16)
    _, (q, k, v, do) = bwd_inputs(shape, seed=5)
    q, k = q * 4, k * 4            # scores past the softcap's linear range
    for fault, kw in (("no-delta", {}),
                      ("no-softcap-derivative", dict(softcap=2.0)),
                      ("skip-last-tile", {}),
                      ("skip-first-tile", dict(window=70))):
        kw = dict(dict(causal=True, window=0, softcap=0.0), **kw)
        o = attention_ref(q, k, v, **kw)
        good = attention_bwd_ref(q, k, v, o, do, **kw)
        bad = tchecks.attention_bwd_faulty(q, k, v, o, do, fault, **kw)
        scales = tchecks.bwd_row_scales(q, k, v, o, do, **kw)
        worst = max(tchecks.grad_row_err(b, g, m)
                    for b, g, m in zip(bad, good, scales))
        assert worst > 0.1, (fault, worst)


@pytest.mark.parametrize("shape,causal,window,softcap", BWD_GRID)
def test_bwd_row_scales_bound_the_rows(shape, causal, window, softcap):
    """Each gradient row's scale is at least the row's norm (up to the
    f32 rounding of the scale itself), and the plain version in f32 stays
    within 1e-5 of each scale from the same formula in f64."""
    _, (q, k, v, do) = bwd_inputs(shape, seed=7)
    q, k = q * 4, k * 4                    # peaked rows, as on the card
    kw = dict(causal=causal, window=window, softcap=softcap)
    o = attention_ref(q, k, v, **kw)
    got = attention_bwd_ref(q, k, v, o, do, **kw)
    scales = tchecks.bwd_row_scales(q, k, v, o, do, **kw)
    want = _bwd_f64(q, k, v, o, do, **kw)
    for g, w, m in zip(got, want, scales):
        assert (m >= w.norm(dim=-1) * (1 - 1e-4)).all()
        assert tchecks.grad_row_err(g, w, m) <= 1e-5


def _bwd_f64(q, k, v, o, do, *, causal, window, softcap):
    """attention_bwd_ref's formula in f64."""
    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))
    sq, skv, hd = q.shape[1], k.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    t = torch.tanh(s / softcap) if softcap else None
    if softcap:
        s = t * softcap
    i = torch.arange(sq)[:, None]
    j = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= i >= j
    if window:
        mask &= i - j < window
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - (do * o).sum(-1).transpose(1, 2)[..., None])
    if softcap:
        ds = ds * (1 - t * t)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k) / np.sqrt(hd),
            torch.einsum("bhqk,bqhd->bkhd", ds, q) / np.sqrt(hd),
            torch.einsum("bhqk,bqhd->bkhd", p, do))


def test_visited_tiles_mirror_the_kernel():
    """checks.visited_tiles is the .cu's kv_tile_range."""
    begin, end = tchecks.visited_tiles(200, 200, True, 70)
    assert (begin[:64] == 0).all() and (end[:64] == 1).all()
    assert begin[130].item() == (128 - 70 + 1) // 64 and end[130] == 3
    src = tKB.SOURCE.read_text()
    assert "constexpr int BQ = 64;" in src and tchecks.TILE == 64
    assert "if (lo > 0) kt_begin = lo / BK;" in src


def test_bwd_build_is_its_own_library_and_lazy():
    path = tKB.SOURCE
    assert path.name == "flash_attention_bwd.cu" and path != tK.SOURCE
    assert tKB.library.cache_info().currsize == 0
    assert tKB.MAX_HEAD_DIM == 128


def test_bwd_cuda_rejects_what_it_does_not_take():
    """The backward's wrapper checks device, dtype, shapes and head dim
    before it builds or launches anything."""
    _, (q, k, v, do) = bwd_inputs((1, 16, 16, 1, 16))
    with pytest.raises(ValueError, match="one CUDA device"):
        tKB.flash_attention_bwd_cuda(q, k, v, q, do)
    assert tKB.library.cache_info().currsize == 0
