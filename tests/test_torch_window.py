"""The port's sliding-window decoders (h2o-danube-3-4b, mixtral-8x7b), the
ring-buffer KV cache (``DecoderLM.window_cache``) and internvl2's
patch-embed prefix against the reference JAX package: the same weights
(the reference's ``init`` through the bridge) and the same inputs, made
with numpy from a seed, give the same logits, caches and lengths.  f32 at
the reference kernel tests' 2e-5, bf16 at 5e-2."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import common as tC  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WINDOWED = ["h2o-danube-3-4b", "mixtral-8x7b"]


def no_drop(cfg):
    """cfg with an expert capacity that drops no token (MoE only)."""
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=16.0))


def pair(arch, dtype, seed=0, edit=lambda cfg: cfg):
    """(jax model, jax params, torch model, bridged torch params), both
    configs passed through ``edit``."""
    jm = jax_build(edit(get_smoke(arch).replace(dtype=dtype)))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = torch_build(edit(torch_smoke(arch).replace(dtype=dtype)))
    tp = params_from_flat({k: np.asarray(v) for k, v in _flatten(jp)})
    return jm, jp, tm, tp


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **TOL[dtype])


# ------------------------------------------------ sliding_window_attention

def qkv(b, s, h, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, hd)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("window", [1, 16, 700])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliding_window_attention_matches_reference(window, dtype):
    """700 rows: a whole 512-row q block and a ragged one; windows of one
    key, of 16 and of the whole sequence."""
    q, k, v = qkv(2, 700, 3, 16, dtype)
    jt = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    want = jA.sliding_window_attention(*jt, window=window)
    tt = [torch.from_numpy(x).to(TORCH_DTYPE[dtype]) for x in (q, k, v)]
    got = tA.sliding_window_attention(*tt, window=window)
    assert got.shape == (2, 700, 3, 16) and got.dtype == TORCH_DTYPE[dtype]
    close(want, got, dtype)


@pytest.mark.parametrize("window,softcap,block_q", [(16, 0.0, 64),
                                                    (40, 5.0, 32)])
def test_sliding_window_attention_is_k1s_function(window, softcap, block_q):
    """The O(s·w) form and K1's dispatcher (its plain version on the CPU)
    compute one function, at any q block and with a softcap; the
    reference's sliding_window_attention agrees with both."""
    q, k, v = qkv(1, 150, 2, 8, "float32", seed=2)
    tt = [torch.from_numpy(x) for x in (q, k, v)]
    got = tA.sliding_window_attention(*tt, window=window, softcap=softcap,
                                      block_q=block_q)
    k1 = flash_ops.flash_attention(*tt, causal=True, window=window,
                                   softcap=softcap)
    torch.testing.assert_close(got, k1, **TOL["float32"])
    want = jA.sliding_window_attention(
        *(jnp.asarray(x) for x in (q, k, v)), window=window,
        softcap=softcap, block_q=block_q)
    close(want, got, "float32")


def test_sliding_window_attention_rejects_no_window():
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="positive int"):
        tA.sliding_window_attention(q, q, q, window=0)


# ---------------------------------------------- the windowed decoders

@pytest.mark.parametrize("arch", WINDOWED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_models_match_reference(arch, dtype):
    """Window 16, a 40-token prompt (the window bites in prefill), then 8
    decode steps (and in every one of them).  The reference prefills
    through sliding_window_attention, the port through K1's dispatcher."""
    jm, jp, tm, tp = pair(arch, dtype)
    assert tm.static_window == jm.static_window == 16
    toks = tokens(jm.cfg, 2, 40)
    max_len = 48
    jl, jcache, jlen = jax.jit(lambda p, t: jm.prefill(p, t, max_len))(
        jp, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), max_len)
    assert tlen == int(jlen) == 40
    close(jl, tl, dtype)
    close(jcache["k"], tcache["k"], dtype)
    close(jcache["v"], tcache["v"], dtype)
    step = jax.jit(jm.decode)
    nxt_all = tokens(jm.cfg, 2, 8, seed=5)
    for i in range(8):
        nxt = nxt_all[:, i:i + 1]
        jl, jcache, jlen = step(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
        assert tlen == int(jlen) == 41 + i
        close(jl, tl, dtype)
    close(jcache["k"], tcache["k"], dtype)
    close(jcache["v"], tcache["v"], dtype)


def full_logits(model, params, toks, patch_embeds=None):
    """Logits at every token position from one cache-free forward."""
    x = model._embed_inputs(params, toks, patch_embeds)
    pos = torch.arange(x.shape[1])[None, :]
    x = model._run_layers(x, params, pos, None, None, "train")[0]
    x = tL.apply_norm(x[:, x.shape[1] - toks.shape[1]:],
                      params["final_norm"], model.cfg)
    return tC.lm_logits(x, params["embed"], model.cfg)


@pytest.mark.parametrize("arch", WINDOWED)
def test_window_cache_ring_matches_reference(arch):
    """The ring: a cache of 16 slots = the window, a 12-token prompt, 30
    decode steps (the ring wraps at step 4 and twice more).  Logits and
    the ring's slots equal the reference's with its knob on, and the
    logits equal the port's own full-cache windowed decode and one
    forward over the whole sequence (experts with room for every token,
    so that the forward's 84 tokens and a step's 2 drop none)."""
    jm, jp, tm, tp = pair(arch, "float32", seed=3, edit=no_drop)
    jm.window_cache = tm.window_cache = True
    full = torch_build(tm.cfg)                    # window_cache off
    toks = tokens(jm.cfg, 2, 42, seed=6)
    W = tm.static_window
    jl, jcache, jlen = jm.prefill(jp, jnp.asarray(toks[:, :12]), W)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks[:, :12]), W)
        fl, fcache, flen = full.prefill(tp, torch.from_numpy(toks[:, :12]),
                                        42)
        ref = full_logits(full, tp, torch.from_numpy(toks))
    assert tcache["k"].shape[2] == W
    close(jl, tl, "float32")
    torch.testing.assert_close(tl, fl, **TOL["float32"])
    step = jax.jit(jm.decode)
    for i in range(12, 42):
        nxt = toks[:, i:i + 1]
        jl, jcache, jlen = step(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
            fl, fcache, flen = full.decode(tp, fcache, torch.from_numpy(nxt),
                                           flen)
        assert tlen == flen == int(jlen) == i + 1
        close(jl, tl, "float32")
        torch.testing.assert_close(tl, fl, **TOL["float32"])
        torch.testing.assert_close(tl[:, 0], ref[:, i], **TOL["float32"])
    close(jcache["k"], tcache["k"], "float32")
    close(jcache["v"], tcache["v"], "float32")
    # the ring holds the last W positions' keys, each at its slot p % W
    slots = np.arange(42 - W, 42) % W
    torch.testing.assert_close(tcache["k"][:, :, slots],
                               fcache["k"][:, :, 42 - W:42])


# ------------------------------------------------ the patch-embed prefix

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_prefix_matches_reference(dtype):
    """internvl2 smoke: 8 patch embeddings in front of a 6-token prompt,
    then 4 decode steps.  Logits, the cache of max_len + 8 slots and the
    lengths equal the reference's."""
    jm, jp, tm, tp = pair("internvl2-76b", dtype)
    P, d = jm.cfg.n_vision_patches, jm.cfg.d_model
    assert P == 8
    patches = np.random.default_rng(7).standard_normal(
        (2, P, d)).astype(np.float32)
    toks = tokens(jm.cfg, 2, 10, seed=8)
    max_len = 12
    jl, jcache, jlen = jm.prefill(jp, jnp.asarray(toks[:, :6]), max_len,
                                  jnp.asarray(patches))
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks[:, :6]),
                                      max_len, torch.from_numpy(patches))
    assert tlen == int(jlen) == P + 6
    assert tcache["k"].shape[2] == jcache["k"].shape[2] == max_len + P
    close(jl, tl, dtype)
    close(jcache["k"], tcache["k"], dtype)
    close(jcache["v"], tcache["v"], dtype)
    for i in range(6, 10):
        nxt = toks[:, i:i + 1]
        jl, jcache, jlen = jm.decode(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
        assert tlen == int(jlen) == P + i + 1
        close(jl, tl, dtype)
    close(jcache["k"], tcache["k"], dtype)


def test_patch_prefix_decode_matches_full_forward():
    """Prefill with patches, then teacher-forced decode, reproduces one
    forward over [patches; tokens] at every token position (f32)."""
    tm = torch_build(torch_smoke("internvl2-76b").replace(dtype="float32"))
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    patches = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 8, tm.cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(tokens(tm.cfg, 1, 12, seed=10))
    with torch.inference_mode():
        ref = full_logits(tm, tp, toks, patches)
        logits, cache, length = tm.prefill(tp, toks[:, :6], 12, patches)
        torch.testing.assert_close(logits[:, 0], ref[:, 5], rtol=1e-4,
                                   atol=1e-4)
        for i in range(6, 11):
            logits, cache, length = tm.decode(tp, cache, toks[:, i:i + 1],
                                              length)
            torch.testing.assert_close(logits[:, 0], ref[:, i], rtol=1e-4,
                                       atol=1e-4)


def test_jamba_prefill_drops_patch_embeds():
    """The reference's JambaLM.prefill takes ``patch_embeds`` and drops
    it; so does the port's: the same logits, cache and length as without
    them."""
    tm = torch_build(torch_smoke("jamba-1.5-large-398b").replace(
        dtype="float32"))
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(tokens(tm.cfg, 1, 6, seed=11))
    patches = torch.ones((1, 3, tm.cfg.d_model))
    with torch.inference_mode():
        a, ca, la = tm.prefill(tp, toks, 8)
        b, cb, lb = tm.prefill(tp, toks, 8, patches)
    assert la == lb == 6
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ca["attn"]["k"], cb["attn"]["k"], rtol=0,
                               atol=0)
