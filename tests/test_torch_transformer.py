"""The PyTorch port's DecoderLM against the reference JAX DecoderLM on the
smoke configs it covers: the same weights (the reference's ``init``
through the bridge) and the same tokens give the same prefill and decode
logits.  f32 at the reference kernel tests' 2e-5, which the whole smoke
model meets; bf16 at 5e-2."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.models import common as tC  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
ARCHS = ["mistral-nemo-12b", "gemma3-4b", "minicpm-2b"]


def pair(arch, dtype):
    """(jax model, jax params, torch model, bridged torch params)."""
    jm = jax_build(get_smoke(arch).replace(dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(torch_smoke(arch).replace(dtype=dtype))
    tp = params_from_flat({k: np.asarray(v) for k, v in _flatten(jp)})
    return jm, jp, tm, tp


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **TOL[dtype])


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("mistral-nemo-12b", "bfloat16")])
def test_prefill_decode_match_reference(arch, dtype):
    jm, jp, tm, tp = pair(arch, dtype)
    toks = tokens(jm.cfg, 2, 20)
    max_len = 28
    jl, jcache, jlen = jax.jit(lambda p, t: jm.prefill(p, t, max_len))(
        jp, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), max_len)
    assert tl.shape == (2, 1, jm.cfg.vocab_size) and tlen == int(jlen) == 20
    close(jl, tl, dtype)
    close(jcache["k"], tcache["k"], dtype)
    close(jcache["v"], tcache["v"], dtype)
    step = jax.jit(jm.decode)
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for _ in range(3):
        jl, jcache, jlen = step(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
        assert tlen == int(jlen)
        close(jl, tl, dtype)
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    close(jcache["k"], tcache["k"], dtype)


def test_decode_past_max_len_matches_reference():
    """An 8-token prompt into a cache of max_len 8, then two decode steps:
    the reference clamps each write to the cache's last slot
    (dynamic_update_slice) and attends over every slot; the port does the
    same, with the same logits and lengths, f32 at 2e-5."""
    jm, jp, tm, tp = pair("mistral-nemo-12b", "float32")
    toks = tokens(jm.cfg, 2, 8, seed=4)
    jl, jcache, jlen = jm.prefill(jp, jnp.asarray(toks), 8)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 8)
    close(jl, tl, "float32")
    nxt = np.array([[3], [11]], np.int32)
    for want in (9, 10):
        jl, jcache, jlen = jm.decode(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
        assert tlen == int(jlen) == want
        assert torch.isfinite(tl).all()
        close(jl, tl, "float32")
        nxt = nxt + 1
    close(jcache["k"], tcache["k"], "float32")
    close(jcache["v"], tcache["v"], "float32")


def full_logits(model, params, toks):
    """Logits at every position from one cache-free forward."""
    x = tC.embed(toks, params["embed"], model.cfg)
    pos = torch.arange(x.shape[1])[None, :]
    x = model._run_layers(x, params, pos, None, None, "train")[0]
    x = tL.apply_norm(x, params["final_norm"], model.cfg)
    return tC.lm_logits(x, params["embed"], model.cfg)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2),
                                       ("float32", 1e-4)])
def test_decode_matches_prefill_dense(dtype, tol):
    """Torch mirror of the reference's KV-cache check: teacher-forced
    decode reproduces the logits of a full forward (bf16 at the
    reference's 2e-2)."""
    tm = torch_build(torch_smoke("mistral-nemo-12b").replace(dtype=dtype))
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(tokens(tm.cfg, 1, 12))
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


def test_softcap_and_window_path():
    """gemma3 with an attention softcap: the per-layer window, qk_norm and
    softcap through prefill and decode both agree with the reference."""
    cfg = get_smoke("gemma3-4b").replace(dtype="float32",
                                         attn_logit_softcap=5.0)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.PRNGKey(2))
    tm = torch_build(torch_smoke("gemma3-4b").replace(
        dtype="float32", attn_logit_softcap=5.0))
    tp = params_from_flat({k: np.asarray(v) for k, v in _flatten(jp)})
    toks = tokens(cfg, 1, 24, seed=3)
    jl, jcache, jlen = jm.prefill(jp, jnp.asarray(toks), 26)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 26)
        close(jl, tl, "float32")
        nxt = np.ones((1, 1), np.int32)
        jl, _, _ = jm.decode(jp, jcache, jnp.asarray(nxt), jlen)
        tl, _, _ = tm.decode(tp, tcache, torch.from_numpy(nxt), tlen)
    close(jl, tl, "float32")


@pytest.mark.parametrize("arch,match", [
    ("whisper-tiny", "Whisper"),
])
def test_unported_families_raise(arch, match):
    """The families the factory once refused now build their models:
    Whisper was the last (its parity tests: tests/test_torch_whisper.py)."""
    assert type(torch_build(torch_smoke(arch))).__name__ == f"{match}LM"


def test_init_defaults_to_the_card():
    tm = torch_build(torch_smoke("mistral-nemo-12b"))
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init(torch.Generator().manual_seed(0))
