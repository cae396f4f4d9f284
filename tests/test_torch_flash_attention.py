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
# dims 12 (minicpm), 256 (gemma3) and 120 (h2o-danube-3-4b, windowed)
GRID = [
    (1, 64, 2, 64, True, 0),
    (2, 100, 3, 32, True, 16),
    (1, 128, 2, 128, False, 0),
    (1, 257, 1, 64, True, 64),
    (2, 48, 4, 16, True, 0),
    (2, 100, 6, 12, True, 0),
    (1, 96, 2, 256, True, 0),
    (1, 130, 2, 120, True, 64),
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


def qkv_narrow_v(shape_q, dv, dtype="float32", seed=0):
    """qkv's inputs with v of dv < hd columns: (jax q, k, v zero-padded to
    hd) and (torch q, k, v at dv)."""
    b, sq, h, hd = shape_q
    rng = np.random.default_rng(seed)
    q, k = (rng.uniform(-1, 1, shape_q).astype(np.float32) for _ in "qk")
    v = rng.uniform(-1, 1, (b, sq, h, dv)).astype(np.float32)
    vp = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, hd - dv)))
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, vp)],
            [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape_q,dv", [((1, 96, 2, 192), 128),
                                        ((2, 40, 2, 24), 16)])
def test_dispatch_with_narrower_v_matches_pallas_on_padded_v(shape_q, dv,
                                                             causal, dtype):
    """v of dv < hd columns (MLA's 128 beside q·k's 192; the smoke
    config's 16 beside 24): the dispatcher's output is the Pallas
    kernel's on v zero-padded to hd, its first dv columns."""
    (jq, jk, jvp), (tq, tk, tv) = qkv_narrow_v(shape_q, dv, dtype, seed=11)
    ref = flash_attention_pallas(jq, jk, jvp, causal=causal, block_q=32,
                                 block_k=32, interpret=True)[..., :dv]
    out = tops.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == TDT[dtype] and out.shape == shape_q[:3] + (dv,)
    close(ref, out, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_cpu_grads_with_narrower_v_equal_the_padded_calls(causal):
    """On the CPU, q, k and v's gradients through the dispatcher with v at
    dv < hd equal those of the padded call (v zero-padded to hd, o sliced
    to dv), v's at its dv columns."""
    _, (q, k, v) = qkv_narrow_v((2, 40, 2, 24), 16, seed=12)
    do = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, 40, 2, 16)).astype(np.float32))
    grads = []
    for padded in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        qq, kk, vv = leaves
        if padded:
            vv = torch.nn.functional.pad(vv, (0, 8))
        out = tops.flash_attention(qq, kk, vv, causal=causal)[..., :16]
        grads.append(torch.autograd.grad(out, leaves, do))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


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


@pytest.mark.parametrize("case", ["dv-past-hd", "dv-0", "v-heads",
                                  "v-rows", "v-batch"])
def test_dispatch_rejects_a_v_that_does_not_fit_k(case):
    """v is (b, skv, h, dv) with 1 <= dv <= hd and k's first three dims;
    anything else raises before any launch."""
    _, (tq, tk, tv) = qkv((2, 16, 2, 16))
    v = {"dv-past-hd": torch.zeros(2, 16, 2, 24),
         "dv-0": torch.zeros(2, 16, 2, 0),
         "v-heads": tv[:, :, :1],
         "v-rows": tv[:, :8],
         "v-batch": tv[:1]}[case]
    with pytest.raises(ValueError, match="1 <= dv <= hd"):
        tops.flash_attention(tq, tk, v)


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


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "jamba-1.5-large-398b",
                                  "h2o-danube-3-4b"])
def test_plan_of_the_models_own_qkv_is_hopper(arch):
    """q, k, v as DecoderLM/JambaLM prefill builds them at full width (the
    projections' reshape, RoPE where the model has it, the GQA repeat),
    on the meta device: the serving path's strides go to the Hopper
    variant, danube's hd 120 included."""
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
    """hd 256 with v narrower than q and k has no Hopper instantiation
    (the Hopper variant takes (256, 256) alone)."""
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
            if n == 256:
                v = meta((b, s, h, 128))
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
    # the Hopper entry takes exactly HOPPER_HEAD_DIM_PAIRS; training mode
    # (an lse) at hd = dv in LSE_HEAD_DIMS (64, 128, 256) alone
    assert ("const bool square =\n      hd == dv && (hd == 64 || hd == 120 "
            "|| hd == 128 || hd == 256);") in hopper
    assert "const bool training = square && hd != 120;" in hopper
    assert ("if (!(square || (hd == 192 && dv == 128)) || (lse != nullptr "
            "&& !training))") in hopper
    assert tK.HOPPER_HEAD_DIM_PAIRS == ((64, 64), (120, 120), (128, 128),
                                        (192, 128), (256, 256))
    assert tK.HOPPER_HEAD_DIMS == (64, 120, 128, 192, 256)
    assert tK.LSE_HEAD_DIMS == (64, 128, 256)
    assert set(tK.LSE_HEAD_DIMS) == {hd for hd, dv in tK.HOPPER_HEAD_DIM_PAIRS
                                     if hd == dv and hd != 120}
    # hd 256: 64-row kv tiles, one Q buffer, two stages; its K and V
    # boxes take the tile's rows; serving and training, softcap both ways
    assert "using Hd256Tile = Tile<256, 256, 64, 1, 2>;" in hopper
    assert ": hd == 256 ? hopper::Hd256Tile::BK" in hopper
    assert "using hopper::Hd256Tile;" in hopper
    for cap in ("true", "false"):
        assert f"hopper::launch_lse<Hd256Tile, {cap}>" in hopper
    assert "void wgmma_rs<256>(float (&d)[128]," in hopper
    assert "m64n256k16.f32.bf16.bf16" in hopper
    # hd 120 and MLA's (192, 128): the serving instantiations only, both
    # with and without a softcap, padded to whole TMA boxes
    assert "hopper::launch_serving<SquareTile<120>>" in hopper
    assert "hopper::launch_serving<hopper::MlaTile>" in hopper
    assert "launch_lse<SquareTile<120>" not in hopper
    assert "launch_lse<hopper::MlaTile" not in hopper
    assert ("softcap != 0.f ? launch<T, true, false>(mq, mk, mv, p, b, "
            "stream)") in hopper
    assert "using MlaTile = Tile<192, 128, " in hopper
    assert "static constexpr int NB = (HD + BOX - 1) / BOX;" in hopper
    assert "static constexpr int NBV = (HDV + BOX - 1) / BOX;" in hopper
    assert "static constexpr int Q_BYTES = BQ * HDP * 2;" in hopper
    assert "static constexpr int V_BYTES = BK * HDVP * 2;" in hopper
    assert "for (int n = 0; n < T::HDV / 8; ++n)" in hopper
    # V's tensor map has dv columns: TMA zero-fills a box past them
    assert "res = hopper::make_map(&mv, encode, v, b, skv, h, dv," in hopper
    assert "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE" in hopper
    assert set(tK.VARIANTS) == set(tops.launches_by_variant)


@pytest.mark.parametrize("case,variant", [
    ("mla", "hopper"), ("mla-softcap", "hopper"), ("mla-strided", "hopper"),
    ("qk-halves", "hopper"), ("square-192", "general"), ("f32", "general"),
    ("v-head-stride-not-16-bytes", "general"), ("dv-64", "general"),
])
def test_plan_routes_mla_head_dims(case, variant):
    """q and k at 192 columns with v at 128 (MLA) in bf16 take the Hopper
    variant where TMA reads them (contiguous, a (b, h, s, hd) storage, q
    and k the two halves of one 384-column storage); bf16 (192, 192), f32,
    another dv and a v head stride that is no multiple of 16 bytes take
    the general one."""
    b, s, h = 2, 300, 4
    q = k = meta((b, s, h, 192))
    v = meta((b, s, h, 128))
    if case == "mla-strided":
        q = k = meta((b, h, s, 192)).transpose(1, 2)
        v = meta((b, h, s, 128)).transpose(1, 2)
    elif case == "qk-halves":
        q = meta((b, s, h, 384))[..., :192]
        k = meta((b, s, h, 384), offset=192)[..., 192:]
        assert q.stride(2) == k.stride(2) == 384
    elif case == "square-192":
        v = meta((b, s, h, 192))
    elif case == "f32":
        q = k = meta((b, s, h, 192), dtype=torch.float32)
        v = meta((b, s, h, 128), dtype=torch.float32)
    elif case == "v-head-stride-not-16-bytes":     # 132 x 2 bytes a head
        v = meta((b, s, h, 128), (s * h * 132, h * 132, 132, 1))
    elif case == "dv-64":
        v = meta((b, s, h, 64))
    assert tK.plan(q, k, v) == variant


def test_plan_of_mla_prefill_qkv_is_hopper():
    """q, k, v as ``mla_prefill`` builds them for deepseek-v3-671b at full
    width (its projections, RoPE, the concatenations, v at v_head_dim), on
    the meta device: the Hopper variant at (192, 128)."""
    cfg = get_config("deepseek-v3-671b")
    m, nq, d = cfg.mla, cfg.n_heads, cfg.d_model
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    p = {name: meta(shape) for name, shape in (
        ("wq_a", (d, m.q_lora_rank)), ("q_norm", (m.q_lora_rank,)),
        ("wq_b", (m.q_lora_rank, nq * qk_hd)),
        ("wkv_a", (d, m.kv_lora_rank + m.qk_rope_head_dim)),
        ("kv_norm", (m.kv_lora_rank,)),
        ("wk_b", (m.kv_lora_rank, nq * m.qk_nope_head_dim)),
        ("wv_b", (m.kv_lora_rank, nq * m.v_head_dim)))}
    b, s = 4, 916
    x = meta((b, s, d))
    pos = torch.arange(s, device="meta")[None, :].expand(b, s)
    c_kv, k_rope = tA.mla_latents(x, p, cfg, pos)
    q_nope, q_rope = tA.mla_queries(x, p, cfg, pos)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([(c_kv @ p["wk_b"]).reshape(b, s, nq, m.qk_nope_head_dim),
                   k_rope[:, :, None, :].expand(b, s, nq,
                                                m.qk_rope_head_dim)], -1)
    v = (c_kv @ p["wv_b"]).reshape(b, s, nq, m.v_head_dim)
    assert q.shape == k.shape == (b, s, nq, 192)
    assert v.shape == (b, s, nq, 128)
    assert tK.plan(q, k, v) == "hopper"


@pytest.mark.parametrize("case,variant", [
    ("contiguous", "hopper"), ("gqa-view", "hopper"), ("strided", "hopper"),
    ("padded-storage", "hopper"), ("f32", "general"),
    ("head-stride-not-16-bytes", "general"),
])
def test_plan_routes_hd120(case, variant):
    """hd 120 (h2o-danube-3-4b) in bf16 takes the Hopper variant where TMA
    reads it: contiguous (a 240-byte head stride), an expanded GQA view
    (stride-0 heads), a (b, h, s, hd) storage, and the first 120 columns
    of a (b, s, h, 128) storage; f32 and a head stride that is no
    multiple of 16 bytes take the general one."""
    b, s, h, hd = 2, 300, 4, 120
    q = k = v = meta((b, s, h, hd))
    if case == "gqa-view":
        k = v = meta((b, s, 1, hd)).expand(b, s, h, hd)
        assert k.stride(2) == 0
    elif case == "strided":
        q = k = v = meta((b, h, s, hd)).transpose(1, 2)
    elif case == "padded-storage":
        q = k = v = meta((b, s, h, 128))[..., :hd]
        assert q.stride() == (s * h * 128, h * 128, 128, 1)
    elif case == "f32":
        q = k = v = meta((b, s, h, hd), dtype=torch.float32)
    elif case == "head-stride-not-16-bytes":       # 124 x 2 bytes a head
        q = meta((b, s, h, hd), (s * h * 124, h * 124, 124, 1))
    assert tK.plan(q, k, v) == variant


def test_hopper_lse_at_hd120_raises_before_any_build():
    """The Hopper forward has no training mode at hd 120 (the Hopper
    backward takes none): an lse raises before the library is loaded."""
    _, (tq, tk, tv) = qkv((1, 16, 2, 120), dtype="bfloat16")
    with pytest.raises(ValueError, match="lse only at hd"):
        tK.flash_attention_cuda(tq, tk, tv, "hopper", lse=tK.lse_buffer(tq))
    assert tK.library.cache_info().currsize == 0


def test_hopper_lse_at_mla_head_dims_raises_before_any_build():
    """Nor at MLA's (192, 128), which only serves: an lse raises before
    the library is loaded."""
    _, (tq, tk, tv) = qkv_narrow_v((1, 16, 2, 192), 128, "bfloat16")
    with pytest.raises(ValueError, match="lse only at hd"):
        tK.flash_attention_cuda(tq, tk, tv, "hopper", lse=tK.lse_buffer(tq))
    assert tK.library.cache_info().currsize == 0


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


def test_dkdv_past_128_fault_exceeds_the_limits():
    """Columns 128.. of dK and dV dropped (the half a backward that kept
    hd 128's column ownership would never write) move dk and dv far past
    the f32 limit and leave dq alone; below hd 129 the fault cannot
    happen."""
    shape = (1, 96, 96, 2, 136)
    _, (q, k, v, do) = bwd_inputs(shape, seed=5)
    kw = dict(causal=True, window=0, softcap=0.0)
    o = attention_ref(q, k, v, **kw)
    good = attention_bwd_ref(q, k, v, o, do, **kw)
    bad = tchecks.attention_bwd_faulty(q, k, v, o, do,
                                       "dkdv-past-128-dropped", **kw)
    scales = tchecks.bwd_row_scales(q, k, v, o, do, **kw)
    torch.testing.assert_close(bad[0], good[0], **BWD_TOL)
    for g in (1, 2):
        assert tchecks.grad_row_err(bad[g], good[g], scales[g]) > 0.1
    with pytest.raises(ValueError, match="no columns past 128"):
        tchecks.attention_bwd_faulty(q[..., :128], k[..., :128],
                                     v[..., :128], o[..., :128],
                                     do[..., :128], "dkdv-past-128-dropped")


# above hd 128, K1's backward on the card splits each 16-row slice's
# columns across two warps (bf16) or takes 32-row tiles (f32): the
# gradient it is held to on the card (autograd through ref.py) against
# jax.grad of the reference's twin.  (b, s, h, hd), causal, window,
# softcap, GQA: KV heads repeated to h on both sides
BWD_WIDE_GRID = [
    ((1, 48, 2, 256), True, 0, 0.0, 1),
    ((1, 48, 2, 256), True, 16, 0.0, 1),
    ((1, 48, 2, 256), True, 0, 30.0, 1),
    ((1, 48, 4, 256), True, 0, 0.0, 2),
]


def _twin_grads(q, k, v, do, kv_heads, dv=None, **kw):
    """jax.grad of the reference twin contracted with dO, at GQA's
    unrepeated k and v (repeated to q's heads inside); with ``dv``, v is
    zero-padded to hd and o sliced back to dv, as the reference's
    mla_prefill does."""
    rep = q.shape[2] // kv_heads

    def f(a, b, c):
        b, c = (jnp.repeat(t, rep, axis=2) for t in (b, c))
        if dv is not None:
            c = jnp.pad(c, ((0, 0), (0, 0), (0, 0), (0, a.shape[3] - dv)))
        o = jA.flash_attention(a, b, c, block_kv=32, **kw)
        return jnp.sum(o[..., :c.shape[3] if dv is None else dv] * do)

    return jax_grad(f, argnums=(0, 1, 2))(q, k, v)


def _port_grads(q, k, v, do, kv_heads, **kw):
    """Autograd through the port's dispatcher on the CPU (ref.py's plain
    version), KV heads repeated as the model repeats them."""
    rep = q.shape[2] // kv_heads
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    kk, vv = (t.repeat_interleave(rep, dim=2) for t in leaves[1:])
    o = tops.flash_attention(leaves[0], kk, vv, **kw)
    return torch.autograd.grad(o, leaves, torch.from_numpy(do))


@pytest.mark.parametrize("shape,causal,window,softcap,kv_heads",
                         BWD_WIDE_GRID)
def test_plain_grads_at_hd256_match_jax_grad_of_the_twin(shape, causal,
                                                         window, softcap,
                                                         kv_heads):
    b, s, h, hd = shape
    rng = np.random.default_rng(21)
    q = rng.uniform(-1, 1, shape).astype(np.float32)
    k, v = (rng.uniform(-1, 1, (b, s, kv_heads, hd)).astype(np.float32)
            for _ in "kv")
    do = rng.uniform(-1, 1, shape).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _twin_grads(q, k, v, do, kv_heads, **kw)
    got = _port_grads(q, k, v, do, kv_heads, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_grads_with_v_at_128_beside_192_match_jax_grad(causal):
    """MLA's (192, 128): the port's v unpadded; the reference's v
    zero-padded to 192 and o sliced back to 128."""
    rng = np.random.default_rng(22)
    q, k = (rng.uniform(-1, 1, (1, 40, 2, 192)).astype(np.float32)
            for _ in "qk")
    v = rng.uniform(-1, 1, (1, 40, 2, 128)).astype(np.float32)
    do = rng.uniform(-1, 1, (1, 40, 2, 128)).astype(np.float32)
    want = _twin_grads(q, k, v, do, 2, dv=128, causal=causal)
    got = _port_grads(q, k, v, do, 2, causal=causal)
    assert got[2].shape == (1, 40, 2, 128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("fault,kw", [
    ("no-delta", {}),
    ("no-softcap-derivative", dict(softcap=2.0)),
    ("skip-last-tile", {}),
    ("skip-first-tile", dict(window=70)),
    ("lse-neighbour-row", {}),
    ("lse-log2", {}),
    ("stale-q-stage", {}),
    # the Hopper backward's hand-off at hd 256, with and without a softcap
    ("stale-exchanged-half", dict(hd=256)),
    ("stale-exchanged-half", dict(hd=256, softcap=30.0)),
    ("stale-q-stage", dict(hd=256)),
])
def test_bwd_faults_exceed_the_limits(fault, kw):
    """Each fault chip_smoke.py holds the kernel against moves the
    gradient far past the f32 limit."""
    assert fault in tchecks.FAULTS
    kw = dict(kw)
    shape = (1, 160, 160, 2, kw.pop("hd", 16))
    _, (q, k, v, do) = bwd_inputs(shape, seed=5)
    q, k = q * 4, k * 4            # scores past the softcap's linear range
    kw = dict(dict(causal=True, window=0, softcap=0.0), **kw)
    o = attention_ref(q, k, v, **kw)
    good = attention_bwd_ref(q, k, v, o, do, **kw)
    bad = tchecks.attention_bwd_faulty(q, k, v, o, do, fault, **kw)
    scales = tchecks.bwd_row_scales(q, k, v, o, do, **kw)
    worst = max(tchecks.grad_row_err(b, g, m)
                for b, g, m in zip(bad, good, scales))
    assert worst > 0.1, (fault, worst)


def test_stale_stage_fault_touches_only_dk_dv():
    """The stale ring stage is one of dK/dV's: dq stays the plain one.
    It is as stale as the ring's rows (128 at hd 64, 64 at hd 128 and
    256): dK/dV of the first ``ring`` q rows alone are the plain ones,
    of ``ring`` + 8 rows no longer."""
    kw = dict(causal=True, window=0, softcap=0.0)
    _, (q, k, v, do) = bwd_inputs((1, 160, 160, 2, 16), seed=5)
    o = attention_ref(q, k, v, **kw)
    good = attention_bwd_ref(q, k, v, o, do, **kw)
    bad = tchecks.attention_bwd_faulty(q, k, v, o, do, "stale-q-stage",
                                       **kw)
    torch.testing.assert_close(bad[0], good[0], **BWD_TOL)
    assert not torch.allclose(bad[1], good[1], **BWD_TOL)
    for hd, ring in ((64, 128), (128, 64), (256, 64)):
        assert tKB.HOPPER_RING_ROWS["dkdv"][hd] == ring
        _, (q, k, v, do) = bwd_inputs((1, 160, 160, 2, hd), seed=5)
        o = attention_ref(q, k, v, **kw)
        for n, same in ((ring, True), (ring + 8, False)):
            args = (q[:, :n], k, v, o[:, :n], do[:, :n])
            good = attention_bwd_ref(*args, **kw)
            bad = tchecks.attention_bwd_faulty(*args, "stale-q-stage", **kw)
            torch.testing.assert_close(bad[0], good[0], **BWD_TOL)
            assert torch.allclose(bad[2], good[2], **BWD_TOL) == same


def test_stale_exchange_fault_is_the_hand_off_of_hd256():
    """"stale-exchanged-half" moves every gradient (the exchange is in
    both kernels), only from the second 64-row tile on: with 64 q and kv
    rows every half comes from the first tile, as it should; below hd 129
    no columns are split and it cannot happen."""
    kw = dict(causal=True, window=0, softcap=0.0)
    for n, same in ((64, True), (160, False)):
        _, (q, k, v, do) = bwd_inputs((1, n, n, 2, 256), seed=6)
        o = attention_ref(q, k, v, **kw)
        good = attention_bwd_ref(q, k, v, o, do, **kw)
        bad = tchecks.attention_bwd_faulty(q, k, v, o, do,
                                           "stale-exchanged-half", **kw)
        for b, g in zip(bad, good):
            assert torch.allclose(b, g, **BWD_TOL) == same
    with pytest.raises(ValueError, match="splits no columns"):
        tchecks.attention_bwd_faulty(q[..., :128], k[..., :128],
                                     v[..., :128], o[..., :128],
                                     do[..., :128], "stale-exchanged-half")


# (hd, dv) at which chip_smoke.py shows each forward fault: hd 120's
# partial box, MLA's third q/k box, hd 256's fourth box
FWD_FAULT_DIMS = {"pad-from-next-head": (120, 120),
                  "second-box-dropped": (120, 120),
                  "third-box-dropped": (192, 128),
                  "fourth-box-dropped": (256, 256)}


@pytest.mark.parametrize("fault", tchecks.FWD_FAULTS)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 30.0)])
def test_forward_faults_exceed_the_limits(fault, window, softcap):
    """Each forward fault chip_smoke.py holds the Hopper forward against
    (at hd 120, MLA's (192, 128) or hd 256) fails the elementwise check and
    lands far past the row limit (bf16's 1e-2, as on the card), on peaked
    inputs as there."""
    rng = np.random.default_rng(8)
    b, s, h = 1, 160, 3
    hd, dv = FWD_FAULT_DIMS[fault]
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                .astype(np.float32) * scale)
               for d, scale in ((hd, 2.0), (hd, 2.0), (dv, 1.0)))
    kw = dict(causal=True, window=window, softcap=softcap)
    good = attention_ref(q, k, v, **kw)
    bad = attention_ref(*tchecks.forward_fault_inputs(q, k, v, fault),
                        **kw)[..., :dv]
    assert bad.shape == good.shape
    assert not torch.allclose(bad, good, rtol=1e-2, atol=1e-2)
    rows = (bad - good).norm(dim=-1) / good.norm(dim=-1)
    assert rows.max().item() > 0.1, (fault, rows.max().item())


def test_pad_from_next_head_keeps_the_last_head():
    """The fault's padding is zeros for the last head (past the
    flattened map's extent), and there the padded, rescaled inputs give
    the plain output: the rescale is the kernel's 1/sqrt(hd).  Every
    other head moves."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 3, 120))
                                .astype(np.float32) * scale)
               for scale in (2.0, 2.0, 1.0))
    good = attention_ref(q, k, v)
    fq, fk, fv = tchecks.forward_fault_inputs(q, k, v, "pad-from-next-head")
    assert fq.shape == fk.shape == fv.shape == (2, 40, 3, 128)
    torch.testing.assert_close(fk[:, :, :2, 120:], k[:, :, 1:, :8])
    assert not fv[..., 120:].any() and not fk[:, :, 2, 120:].any()
    bad = attention_ref(fq, fk, fv)[..., :120]
    torch.testing.assert_close(bad[:, :, 2], good[:, :, 2], rtol=1e-5,
                               atol=1e-5)
    assert not torch.allclose(bad[:, :, :2], good[:, :, :2], rtol=1e-2,
                              atol=1e-2)


def test_forward_faults_need_a_partial_box():
    _, (q, k, v) = qkv((1, 16, 2, 128))
    with pytest.raises(ValueError, match="whole boxes"):
        tchecks.forward_fault_inputs(q, k, v, "second-box-dropped")
    with pytest.raises(ValueError, match="at most two boxes"):
        tchecks.forward_fault_inputs(q, k, v, "third-box-dropped")
    _, (q, k, v) = qkv((1, 16, 2, 192))
    with pytest.raises(ValueError, match="at most three boxes"):
        tchecks.forward_fault_inputs(q, k, v, "fourth-box-dropped")
    with pytest.raises(ValueError, match="no forward fault"):
        tchecks.forward_fault_inputs(q, k, v, "lost-tile")


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
    assert "kv_tile_range<BQ>(p, q0, &kt_begin, &kt_end);" in src
    assert "if (lo > 0) kt_begin = lo / R;" in src


def test_bwd_build_is_its_own_library_and_lazy():
    path = tKB.SOURCE
    assert path.name == "flash_attention_bwd.cu" and path != tK.SOURCE
    assert tKB.library.cache_info().currsize == 0
    assert tKB.MAX_HEAD_DIM == 256
    assert tuple(tKB.KERNELS) == tKB.VARIANTS == tuple(
        tops.launches_bwd_by_variant)
    assert all(len(ks) == 3 for ks in tKB.KERNELS.values())


def test_bwd_cuda_rejects_what_it_does_not_take():
    """The backward's wrapper checks device, dtype, shapes and head dim
    before it builds or launches anything."""
    _, (q, k, v, do) = bwd_inputs((1, 16, 16, 1, 16))
    for variant in tKB.VARIANTS:
        with pytest.raises(ValueError, match="one CUDA device"):
            tKB.flash_attention_bwd_cuda(q, k, v, q, do, variant)
    with pytest.raises(ValueError, match="no flash attention backward"):
        tKB.flash_attention_bwd_cuda(q, k, v, q, do, "fastest")
    assert tKB.library.cache_info().currsize == 0


# ------------------------------------------------ kernel_bwd.plan (routes)


@pytest.mark.parametrize("case,route", [
    ("training", "hopper"), ("hd128", "hopper"), ("strided", "hopper"),
    ("gqa-view", "hopper"), ("f32", "general"), ("hd120", "general"),
    ("hd32", "general"), ("head-stride-not-16-bytes", "general"),
    ("o-f32", "general"), ("o-seq-stride-not-16-bytes", "general"),
    ("do-refused", "hopper"), ("hd192", "general"), ("hd256", "hopper"),
    ("mla-192-128", "general"), ("gqa-view-hd256", "hopper"),
    ("strided-hd256", "hopper"), ("f32-hd256", "general"),
    ("head-stride-refused-hd256", "general"), ("v128-beside-hd256", "general"),
])
def test_bwd_plan_routes(case, route):
    """kernel_bwd.plan on meta tensors: "hopper" where the forward takes
    its Hopper variant and o is bf16 TMA reads, the (b, h, s, hd) storage
    and an expanded GQA view (stride-0 heads) included; "general" for
    everything else.  A dO TMA refuses never changes the route."""
    b, s, h, hd = 4, 2048, 36, 64
    q = k = v = meta((b, s, h, hd))
    o = None
    if case == "hd128":
        q = k = v = meta((b, s, h, 128))
    elif case == "strided":
        q = k = v = meta((b, h, s, hd)).transpose(1, 2)
    elif case == "gqa-view":
        k = v = meta((b, s, 1, hd)).expand(b, s, h, hd)
        assert k.stride(2) == 0
    elif case == "gqa-view-hd256":       # one KV head seen as all 8
        q = meta((2, s, 8, 256))
        k = v = meta((2, s, 1, 256)).expand(2, s, 8, 256)
        assert k.stride(2) == 0
    elif case == "strided-hd256":
        q = k = v = meta((2, 8, s, 256)).transpose(1, 2)
    elif case == "f32-hd256":
        q = k = v = meta((2, s, 8, 256), dtype=torch.float32)
    elif case == "head-stride-refused-hd256":   # 260 elements, 520 bytes
        q = meta((2, s, 8, 256), (s * 8 * 260, 8 * 260, 260, 1))
        k = v = meta((2, s, 8, 256))
    elif case == "v128-beside-hd256":
        q = k = meta((2, s, 8, 256))
        v = meta((2, s, 8, 128))
    elif case == "f32":
        q = k = v = meta((b, s, h, hd), dtype=torch.float32)
    elif case == "mla-192-128":
        q = k = meta((b, s, h, 192))
        v = meta((b, s, h, 128))
    elif case.startswith("hd"):
        q = k = v = meta((b, s, h, int(case[2:])))
    elif case == "head-stride-not-16-bytes":
        q = meta((b, s, h, hd), (s * h * 68, h * 68, 68, 1))
    elif case == "o-f32":
        o = meta((b, s, h, hd), dtype=torch.float32)
    elif case == "o-seq-stride-not-16-bytes":
        o = meta((b, s, h, hd), (s * (h * hd + 4), h * hd + 4, hd, 1))
    elif case == "do-refused":
        do = meta((b, s, h, hd), (s * h * hd * 2, h * hd * 2, hd * 2, 2))
        assert not tKB.dout_ok(do)
    assert tKB.plan(q, k, v, o) == route
    if route == "hopper" or case in ("hd120", "mla-192-128"):
        # hd 120, MLA: the Hopper forward (no LSE), the general backward
        assert tK.plan(q, k, v) == "hopper"
    if route == "hopper":
        # the Hopper forward in training mode, whose LSE the backward reads
        assert tK.writes_lse(q, k, v)
    elif case not in ("o-f32", "o-seq-stride-not-16-bytes"):
        # no LSE to read: the general route's stats kernel recomputes it
        assert not tK.writes_lse(q, k, v)
    if case == "hd192":
        assert tK.plan(q, k, v) == "general"


def test_bwd_plan_mirrors_the_kernel_source():
    """The head dims, tiles and kernels plan() and the wrapper assume are
    the ones the Hopper backward's source instantiates."""
    src = tKB.SOURCE.read_text()
    hopper = src[src.index("namespace hopper {"):]
    units = tKB.HOPPER_UNIT_ROWS
    assert "constexpr int UNIT_ROWS = %d;" % max(units.values()) in hopper
    ring = tKB.HOPPER_RING_ROWS
    # hd 256 splits the gradients' columns between the consumers, with
    # 64-row units and streamed tiles (the others' 128-row units)
    split = ("static constexpr bool SPLIT = HD == 256;\n"
             "  static constexpr int UNIT = SPLIT ? %d : %d;"
             % (units[256], units[128]))
    assert units[64] == units[128]
    assert ("struct DkdvCfg {\n  " + split + "\n  static constexpr int RING"
            " = HD == 64 ? %d : %d;" % (ring["dkdv"][64], ring["dkdv"][128])
            ) in hopper
    assert ring["dkdv"][256] == ring["dkdv"][128]
    assert ring["dq"][64] == ring["dq"][128]
    assert ("struct DqCfg {\n  " + split + "\n  static constexpr int RING"
            " = SPLIT ? %d : %d;" % (ring["dq"][256], ring["dq"][64])
            ) in hopper
    assert all(tK.LSE_ROW_ALIGN % r == 0 for rows in ring.values()
               for r in rows.values())
    assert all(tK.LSE_ROW_ALIGN % r == 0 for r in units.values())
    # the exchanged tile is one 64 x 64 box; units, rings and the launch
    # take their rows from the config
    assert ("static_assert(!Cfg::SPLIT || (Cfg::UNIT == 64 && Cfg::RING == "
            "BOX),") in hopper
    assert hopper.count("(p.skv + C::UNIT - 1) / C::UNIT * n_bh") == 1
    assert hopper.count("(p.sq + C::UNIT - 1) / C::UNIT * n_bh") == 1
    assert "hd, true, C::RING, C::UNIT);" in hopper
    assert "hd, false, C::RING, C::UNIT);" in hopper
    assert "UNIT_ROWS" not in hopper[hopper.index("struct Params {"):
                                     hopper.index("}  // namespace hopper")]
    entry = src[src.index('extern "C" int flash_attention_bwd_hopper'):]
    assert "if ((hd != 64 && hd != 128 && hd != 256)" in entry
    assert "ls % hopper::UNIT_ROWS != 0" in entry
    assert tKB.HOPPER_HEAD_DIMS == (64, 128, 256) == tK.LSE_HEAD_DIMS
    assert (set(tKB.HOPPER_HEAD_DIMS) == set(ring["dkdv"]) == set(ring["dq"])
            == set(units))
    for hd in tKB.HOPPER_HEAD_DIMS:
        assert f"hopper::launch<{hd}, true>" in entry
        assert f"hopper::launch<{hd}, false>" in entry
        assert f"hopper::launch_preprocess<{hd}>" in entry
    for name in ("bwd_preprocess_hopper", "bwd_dkdv_hopper_kernel",
                 "bwd_dq_hopper_kernel"):
        assert f"{name}(" in hopper
    assert "bwd_stats" not in hopper
    assert tKB.KERNELS["hopper"] == ("preprocess", "dkdv", "dq")
    fwd = tK.SOURCE.read_text()
    assert "template <class T, bool SOFTCAP, bool LSE>" in fwd
    assert "(m[h] + log2f(l[h])) / LOG2E" in fwd
    # the general route reads the forward's LSE where it is handed one:
    # stats computes D alone, every kernel reads lse and delta through
    # the buffer's row stride
    general = src[:src.index("namespace hopper {")]
    assert "template <int HDP, bool LSE_IN>" in general
    assert "if constexpr (!LSE_IN) stats_lse_bf16<HDP>(p, q0, bb, hh);" \
        in general
    assert ("err = p.lse_in ? launch_one(bwd_stats_bf16<HDP, true>, qgrid,"
            in general)
    assert "return (static_cast<long long>(bb) * p.h + hh) * p.ls;" in general
    entry = src[src.index('extern "C" int flash_attention_bwd('):]
    assert "ls < sq ||\n      (lse_in && dtype != 1))" in entry


def test_bwd_block_loads_mirror_the_kernel_source():
    """kernel_bwd.block_loads follows the source's order of units at
    every head dim: the group's streamed bytes, the zigzag in a group and
    the snake over the passes."""
    src = tKB.SOURCE.read_text()
    hopper = src[src.index("namespace hopper {"):]
    assert ("constexpr long long GROUP_BYTES = %dll << 20;"
            % (tKB.HOPPER_GROUP_BYTES >> 20)) in hopper
    assert ("std::min(static_cast<long long>(b) * h,\n"
            "                    hopper::GROUP_BYTES / streamed)") in hopper
    assert "*tile = r & 1 ? n_t - 1 - r / 2 : r / 2;" in hopper
    assert ("const int pos = k & 1 ? gridDim.x - 1 - blockIdx.x : "
            "blockIdx.x;") in hopper
    assert hopper.count("(w = unit_at(k)) < n_units") == 4
    assert hopper.count("unit_of(p, w, ") == 2


# (b, s, h, hd), window, the busiest block's share of the mean in plain
# pass order: gemma3-4b's training shape (a global and a local layer),
# path j's local heads and minicpm-2b's training shape, causal
BALANCE_CASES = [((2, 2048, 8, 256), 0, 1.906),
                 ((2, 2048, 8, 256), 1024, 1.375),
                 ((1, 4096, 16, 128), 0, 1.906),
                 ((4, 2048, 36, 64), 0, 1.24)]


@pytest.mark.parametrize("shape,window,plain", BALANCE_CASES)
@pytest.mark.parametrize("which", ["dkdv", "dq"])
def test_bwd_units_at_hd256_are_balanced(shape, window, plain, which):
    """The Hopper backward's most loaded block works through at most
    1.06x the mean of the streamed tiles at gemma3-4b's training shape
    (2, 2048, 8, 256), at path j's local heads and at minicpm-2b's
    training shape, causal, where plain pass order gave it up to 1.91x;
    every tile of the mask is counted once."""
    b, s, h, hd = shape
    loads = tKB.block_loads(b, s, s, h, hd, window=window, kernel=which)
    assert len(loads) == 132
    unit = tKB.HOPPER_UNIT_ROWS[hd]
    ring = tKB.HOPPER_RING_ROWS[which][hd]
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    seen = (i >= j) & ((i - j < window) if window else True)
    # a unit's streamed tiles: the ring tiles its rows' mask reaches
    if which == "dkdv":
        tiles = seen.reshape(s // ring, ring, s // unit, unit).any(
            axis=(1, 3)).sum()
    else:
        tiles = seen.reshape(s // unit, unit, s // ring, ring).any(
            axis=(1, 3)).sum()
    assert sum(loads) == b * h * tiles
    assert max(loads) <= 1.06 * np.mean(loads)
    old = tKB.block_loads(b, s, s, h, hd, window=window, kernel=which,
                          balance=False)
    assert sum(old) == sum(loads)
    assert max(old) / np.mean(old) == pytest.approx(plain, abs=5e-4)


def test_bwd_general_head_dims_mirror_the_kernel_source():
    """The general backward's instantiations (launch_for_head_dim) are
    the ones kernel_bwd states, f32 takes 32-row tiles and bf16 splits
    columns above hd 128, and its entry takes every hd up to
    MAX_HEAD_DIM with dv <= hd."""
    import re
    src = tKB.SOURCE.read_text()
    general = src[:src.index("namespace hopper {")]
    body = general[general.index("cudaError_t launch_for_head_dim("):]
    pairs = tuple((int(a), int(b)) for a, b in re.findall(
        r"launch_dims<BF16, (\d+), (\d+)>", body))
    assert pairs == tKB.GENERAL_HEAD_DIMS
    assert max(hd for hd, _ in pairs) == tKB.MAX_HEAD_DIM
    assert "return HDP <= 128 ? 64 : 32;" in general    # f32 tile rows
    assert "return HDP <= 128 ? 1 : 2;" in general
    assert "if (p.hd <= 192)\n    return p.hdv <= 128" in body
    entry = src[src.index('extern "C" int flash_attention_bwd('):]
    assert "hd > %d || hdv < 1 ||\n      hdv > hd" % tKB.MAX_HEAD_DIM in entry


def test_function_hands_mla_v_unpadded_to_the_general_backward(monkeypatch):
    """MLA's (192, 128) under a gradient: _FlashAttention takes v at its
    128 columns, the forward on kernel.plan's "hopper" (no LSE), the
    backward on "general" with v, o and dO at 128 columns, dv at 128."""
    calls = _stand_ins(monkeypatch)
    fwd_variants = []
    forward = tK.flash_attention_cuda

    def record(q, k, v, variant, **kw):
        fwd_variants.append((variant, kw["lse"] is not None, v.shape[3]))
        return forward(q, k, v, variant, **kw)

    monkeypatch.setattr(tK, "flash_attention_cuda", record)
    rng = np.random.default_rng(23)
    q, k = (torch.from_numpy(rng.uniform(-1, 1, (1, 40, 2, 192))
                             .astype(np.float32)).bfloat16().requires_grad_()
            for _ in "qk")
    v = torch.from_numpy(rng.uniform(-1, 1, (1, 40, 2, 128)).astype(
        np.float32)).bfloat16().requires_grad_()
    o = tops._FlashAttention.apply(q, k, v, dict(causal=True, window=0,
                                                 softcap=0.0))
    assert o.shape == (1, 40, 2, 128) and o.grad_fn.route == "general"
    o.backward(torch.ones_like(o))
    assert fwd_variants == [("hopper", False, 128)]
    (call,) = calls
    assert call["variant"] == "general" and call["lse"] is None
    assert v.grad.shape == (1, 40, 2, 128)


def test_lse_buffer_rows_are_padded():
    q = meta((2, 1000, 3, 64))
    buf = tK.lse_buffer(q)
    assert buf.shape == (2, 3, 1024) and buf.dtype == torch.float32


def test_lse_goes_only_to_the_hopper_forward():
    _, (tq, tk, tv) = qkv((1, 16, 2, 64), dtype="bfloat16")
    with pytest.raises(ValueError, match="lse must be"):
        tK.flash_attention_cuda(tq, tk, tv, "general",
                                lse=tK.lse_buffer(tq))
    with pytest.raises(ValueError, match="lse must be"):
        tK.flash_attention_cuda(tq, tk, tv, "hopper",
                                lse=torch.empty((1, 2, 16)))
    assert tK.library.cache_info().currsize == 0


# ------------------------------------------------ the LSE (plain)

from jax.nn import logsumexp as jax_logsumexp  # noqa: E402

from repro_torch.kernels.flash_attention.ref import attention_lse  # noqa: E402


def _jax_twin_scores(q, k, *, causal, window, softcap):
    """The reference twin's masked, capped scores (models/attention.py::
    flash_attention's block body, one block): q scaled in f32, the
    softcap, the causal and window masks, NEG_INF."""
    sq, skv, hd = q.shape[1], k.shape[1], q.shape[3]
    qf = (jnp.asarray(q, jnp.float32) / np.sqrt(hd)).transpose(0, 2, 1, 3)
    kf = jnp.asarray(k, jnp.float32).transpose(0, 2, 1, 3)
    s = jA._softcap(jnp.einsum("bhqd,bhkd->bhqk", qf, kf), softcap)
    q_pos = jnp.arange(sq)[:, None]
    k_pos = jnp.arange(skv)[None, :]
    mask = jnp.ones((sq, skv), bool)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    return jnp.where(mask[None, None], s, jA.NEG_INF)


# BWD_GRID, and hd 256 (gemma3-4b, whose Hopper forward writes the LSE
# the general backward reads) with a window, a softcap and GQA: a sixth
# entry of the shape, 1 KV head seen as all of q's (an expanded view, as
# the model hands K1)
LSE_GRID = BWD_GRID + [((1, 70, 70, 2, 256), True, 16, 0.0),
                       ((1, 48, 48, 2, 256), True, 0, 30.0),
                       ((1, 40, 40, 4, 256, 1), True, 0, 0.0)]


@pytest.mark.parametrize("shape,causal,window,softcap", LSE_GRID)
def test_attention_lse_matches_jax_logsumexp_of_the_twin(shape, causal,
                                                         window, softcap):
    """ref.attention_lse, what the forward's training mode writes and the
    backward reads, against jax.nn.logsumexp of the reference twin's
    masked, capped scores (f32, 2e-5)."""
    shape, kv_heads = shape[:5], shape[5:]
    (jq, jk, _, _), (q, k, _, _) = bwd_inputs(shape, seed=11)
    q, k, jq, jk = q * 4, k * 4, jq * 4, jk * 4     # peaked rows
    if kv_heads:
        jk = jnp.repeat(jk[:, :, :1], shape[3], axis=2)
        k = k[:, :, :1].expand(k.shape)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jax_logsumexp(_jax_twin_scores(jq, jk, **kw), axis=-1)
    got = attention_lse(q, k, **kw)
    assert got.shape == (shape[0], shape[3], shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ------------------------------------------------ _FlashAttention routing


def _stand_ins(monkeypatch):
    """CPU stand-ins for the two kernel entry points, calling ref.py: the
    forward writes the plain LSE into the buffer it is given; the
    backward records what it was handed.  Returns the backward's
    records."""
    from repro_torch.kernels.flash_attention import ref as tref
    calls = []

    def forward(q, k, v, variant, *, causal, window, softcap, lse=None):
        kw = dict(causal=causal, window=window, softcap=softcap)
        if lse is not None:
            lse[..., :q.shape[1]] = tref.attention_lse(q, k, **kw)
        return tref.attention_ref(q, k, v, **kw)

    def backward(q, k, v, o, do, variant, *, lse=None, **kw):
        calls.append(dict(variant=variant, lse=lse, do_stride=do.stride(),
                          want_lse=tref.attention_lse(q, k, **kw)))
        return tref.attention_bwd_ref(q, k, v, o, do, **kw)

    monkeypatch.setattr(tK, "flash_attention_cuda", forward)
    monkeypatch.setattr(tKB, "flash_attention_bwd_cuda", backward)
    return calls


@pytest.mark.parametrize("dtype,hd,route", [
    ("bfloat16", 64, "hopper"), ("bfloat16", 128, "hopper"),
    ("float32", 64, "general"), ("bfloat16", 32, "general"),
    ("bfloat16", 120, "general"), ("bfloat16", 256, "hopper"),
])
def test_function_saves_lse_wherever_the_forward_writes_one(monkeypatch,
                                                             dtype, hd,
                                                             route):
    """_FlashAttention saves the forward's LSE through save_for_backward
    wherever its forward writes one (kernel.writes_lse: the Hopper
    variant at hd 64, 128 and 256) and hands it to the backward, which
    takes the "hopper" route at each of them.  Elsewhere it saves none
    (hd 120: the forward still takes its Hopper variant, without an LSE).
    Launches count by route, calls by where their LSE came from."""
    calls = _stand_ins(monkeypatch)
    fwd_variants = []
    forward = tK.flash_attention_cuda

    def record(q, k, v, variant, **kw):
        fwd_variants.append((variant, kw["lse"] is not None))
        return forward(q, k, v, variant, **kw)

    monkeypatch.setattr(tK, "flash_attention_cuda", record)
    _, (q, k, v) = qkv((2, 40, 3, hd), dtype=dtype, seed=4)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    kw = dict(causal=True, window=0, softcap=0.0)
    writes = route == "hopper"
    assert tK.writes_lse(q, k, v) == writes
    before = dict(tops.launches_bwd_by_variant)
    by_lse = dict(tops.bwd_calls_by_lse)
    o = tops._FlashAttention.apply(q, k, v, kw)
    saved = o.grad_fn.saved_tensors
    assert o.grad_fn.route == route
    assert len(saved) == (5 if writes else 4)
    o.backward(torch.ones_like(o))
    (call,) = calls
    assert call["variant"] == route
    assert fwd_variants == [(tK.plan(q, k, v), writes)]
    if writes:
        lse = saved[4]
        assert lse.shape == (2, 3, tK.LSE_ROW_ALIGN)
        assert call["lse"] is lse
        torch.testing.assert_close(lse[..., :40], call["want_lse"])
    else:
        assert call["lse"] is None
    assert tops.launches_bwd_by_variant[route] - before[route] == 3
    source = "forward" if writes else "recomputed"
    assert tops.bwd_calls_by_lse == {**by_lse, source: by_lse[source] + 1}


def test_function_copies_a_dout_tma_refuses(monkeypatch):
    """On the Hopper route a dO TMA cannot read (here: head-dim stride 2)
    is copied to contiguous, the copy counted; the route stays."""
    calls = _stand_ins(monkeypatch)
    _, (q, k, v) = qkv((1, 24, 2, 64), dtype="bfloat16", seed=6)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = tops._FlashAttention.apply(q, k, v, dict(causal=True, window=0,
                                                 softcap=0.0))
    wide = torch.randn((1, 24, 2, 128)).bfloat16()
    copies = tops.bwd_dout_copies
    o.backward(wide[..., ::2])
    assert tops.bwd_dout_copies == copies + 1
    assert calls[0]["variant"] == "hopper"
    assert calls[0]["do_stride"] == (24 * 2 * 64, 2 * 64, 64, 1)
    want = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                             wide[..., ::2], causal=True)
    torch.testing.assert_close(q.grad, want[0])
