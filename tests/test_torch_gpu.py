"""The port on the card: the CUDA flash attention kernel against its plain
version, the dispatcher's rules for CUDA tensors, and DecoderLM prefill
through the kernel against the same model on the CPU.

Every test here needs an NVIDIA GPU and skips without one.  On a machine
with a card, from the repository root:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it also runs where JAX is not installed.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
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


# (b, sq, skv, h, hd), causal, window, softcap, strided
CASES = [
    ((2, 100, 100, 6, 12), True, 0, 0.0, False),
    ((2, 130, 130, 4, 16), True, 16, 0.0, True),
    ((1, 257, 257, 4, 64), True, 64, 0.0, False),
    ((1, 64, 192, 2, 64), False, 0, 0.0, False),
    ((2, 200, 200, 4, 128), True, 0, 0.0, False),
    ((1, 96, 96, 2, 256), True, 0, 30.0, False),
    ((1, 1, 1, 1, 32), True, 0, 0.0, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,causal,window,softcap,strided", CASES)
def test_kernel_matches_plain(cuda, shape, causal, window, softcap, strided,
                              dtype):
    q, k, v = _qkv(*shape, dtype, strided=strided)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = ops.launches
    with torch.inference_mode():
        out = ops.flash_attention(q, k, v, **kw)
        ref = attention_ref(q, k, v, **kw)
    assert ops.launches == before + 1
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
