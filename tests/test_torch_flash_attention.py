"""The PyTorch port's flash attention on the CPU: its plain version (the
one its dispatcher takes for CPU tensors, and the one the CUDA kernel is
held against on the card) against the reference Pallas kernel run in
interpret mode, against the reference oracle, and the port's blockwise
model twin against the reference's.  The CUDA kernel itself runs only on
the card (chip_smoke.py)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402

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
