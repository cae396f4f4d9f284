"""The PyTorch port's WhisperLM against the reference JAX WhisperLM on the
CPU: the sinusoidal position table bit for bit, the cross-attention's
params and projections, ``encode``, ``prefill`` (logits and all four
caches), decode steps (the reference's position-0 embedding, the write
clamped past ``max_len``), ``loss`` and every gradient, the factory and
the cache's shapes.

whisper-tiny's smoke config (2 + 2 layers, d_model 64, 4 heads of 16)
with 16 frames, and one cut at the published widths (d_model 384, 6
heads of 64, vocab 51865; 1 + 1 layers, 32 frames).  Weights are the
reference's ``init`` carried by the bridge; tokens and frames come from
numpy seeds.  Tolerances: f32 2e-5 and bf16 5e-2 (the reference kernel
tests'); a gradient leaf within 1e-4 (f32) or 5e-2 (bf16) of the leaf's
largest |g|, as tests/test_torch_training.py holds them.  On the CPU
prefill attention reaches K1's dispatcher, which takes its plain version.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402
from repro_torch.models.whisper import WhisperLM  # noqa: E402
from repro_torch.training.step import value_and_grad  # noqa: E402

ARCH = "whisper-tiny"
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
GRAD_REL = {"float32": 1e-4, "bfloat16": 5e-2}
DTYPES = ["float32", "bfloat16"]
FRAMES = 16
# whisper-tiny at its published widths, cut to 1 encoder and 1 decoder
# layer
WIDE_CUT = dict(n_layers=1, n_enc_layers=1)


@functools.lru_cache(maxsize=None)
def pair(dtype, wide=False):
    """(jax model, jax params, torch model, bridged torch params)."""
    if wide:
        jcfg = jax_config(ARCH).replace(dtype=dtype, **WIDE_CUT)
        tcfg = torch_config(ARCH).replace(dtype=dtype, **WIDE_CUT)
    else:
        jcfg = get_smoke(ARCH).replace(dtype=dtype)
        tcfg = torch_smoke(ARCH).replace(dtype=dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(tcfg)
    return jm, jp, tm, params_from_flat(
        {k: np.asarray(v) for k, v in _flatten(jp)})


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def frames(cfg, b, n=FRAMES, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model)).astype(np.float32)


def close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **TOL[dtype])


def close_cache(jcache, tcache, dtype):
    assert set(tcache) == set(jcache) == {"k", "v", "ck", "cv"}
    for key in tcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        close(jcache[key], tcache[key], dtype)


def jax_prefill(jm, jp, toks, fr, max_len):
    return jax.jit(lambda p, t, f: jm.prefill(p, t, max_len, frames=f))(
        jp, jnp.asarray(toks), jnp.asarray(fr))


def argmax_tokens(jl):
    return np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]


# ------------------------------------------------------------- building blocks


@pytest.mark.parametrize("n_pos,d_model", [(16, 64), (448, 384),
                                           (1500, 384)])
def test_sinusoidal_positions_bit_for_bit(n_pos, d_model):
    want = np.asarray(jL.sinusoidal_positions(n_pos, d_model))
    got = tL.sinusoidal_positions(n_pos, d_model, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    # one table a (n_pos, d_model, device), shared
    assert tL.sinusoidal_positions(n_pos, d_model, "cpu") is got


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_init_attention_keys_match_reference(qk_norm, cross):
    cfg = torch_smoke(ARCH).replace(qk_norm=qk_norm)
    jcfg = get_smoke(ARCH).replace(qk_norm=qk_norm)
    want = jA.init_attention(jax.random.PRNGKey(0), jcfg, jnp.float32,
                             cross=cross)
    got = tA.init_attention(torch.Generator().manual_seed(0), cfg,
                            torch.float32, "cpu", cross=cross)
    assert set(got) == set(want)
    assert ("q_scale" in got) == (qk_norm and not cross)
    for key in got:
        assert tuple(got[key].shape) == want[key].shape, key


def test_cross_changes_only_the_scales():
    """``cross=True`` draws the same wq, wk, wv, wo from the generator as
    the self-attention's init, and only drops the q/k scales."""
    cfg = torch_smoke(ARCH).replace(qk_norm=True)
    self_p = tA.init_attention(torch.Generator().manual_seed(3), cfg,
                               torch.float32, "cpu", lead=(2,))
    cross_p = tA.init_attention(torch.Generator().manual_seed(3), cfg,
                                torch.float32, "cpu", lead=(2,), cross=True)
    assert set(self_p) - set(cross_p) == {"q_scale", "k_scale"}
    for key in cross_p:
        assert torch.equal(self_p[key], cross_p[key]), key


@pytest.mark.parametrize("qk_norm", [False, True])
def test_project_qkv_kv_x_matches_reference(qk_norm):
    """k and v from ``kv_x`` with its own length (12 against 5), q from
    x; with qk_norm the scales apply to both, as in the reference; with
    kv_x = x the call equals the one without kv_x, bit for bit."""
    jcfg = get_smoke(ARCH).replace(qk_norm=qk_norm, dtype="float32")
    tcfg = torch_smoke(ARCH).replace(qk_norm=qk_norm, dtype="float32")
    jp = jA.init_attention(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    kv_x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    want = jA.project_qkv(jnp.asarray(x), jp, jcfg, kv_x=jnp.asarray(kv_x))
    got = tA.project_qkv(torch.from_numpy(x), tp, tcfg,
                         kv_x=torch.from_numpy(kv_x))
    for j, t, s in zip(want, got, (5, 12, 12)):
        assert t.shape == (2, s, tcfg.n_heads, tcfg.resolved_head_dim)
        close(j, t, "float32")
    tx = torch.from_numpy(x)
    for a, b in zip(tA.project_qkv(tx, tp, tcfg, kv_x=tx),
                    tA.project_qkv(tx, tp, tcfg)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ the model


def test_build_model_gives_whisper():
    for cfg in (torch_smoke(ARCH), torch_config(ARCH)):
        model = torch_build(cfg)
        assert isinstance(model, WhisperLM) and model.cfg is cfg


def test_init_matches_the_reference_layout():
    """The port's own init has the reference's paths, shapes and dtype;
    the bridge carries the reference's ``enc``/``dec`` stacks, ``enc_ln``
    and the tied ``embed`` into the port bit for bit."""
    jm, jp, tm, tp = pair("bfloat16")
    jflat = {k: np.asarray(v) for k, v in _flatten(jp)}
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert {p for p, _ in T.flatten(own)} == set(jflat)
    for path, leaf in T.flatten(own):
        assert tuple(leaf.shape) == jflat[path].shape, path
        assert leaf.dtype == torch.bfloat16, path
    assert "embed/lm_head" not in jflat      # tied
    for path in ("enc/attn/wq", "enc/mlp/up", "enc_ln/scale",
                 "dec/xattn/wk", "dec/ln_x/scale", "embed/tokens"):
        assert path in jflat
    for path, leaf in T.flatten(tp):
        assert np.array_equal(leaf.view(torch.int16).numpy(),
                              jflat[path].view(np.int16)), path
    assert tp["enc"]["attn"]["wq"].shape[0] == tm.cfg.n_enc_layers
    assert tp["dec"]["xattn"]["wq"].shape[0] == tm.cfg.n_layers


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    jm, jp, tm, tp = pair(dtype)
    fr = frames(jm.cfg, 2)
    want = jax.jit(jm.encode)(jp, jnp.asarray(fr))
    with torch.inference_mode():
        got = tm.encode(tp, torch.from_numpy(fr))
    assert got.shape == (2, FRAMES, tm.cfg.d_model)
    assert got.dtype == tm.dtype
    close(want, got, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_reference(dtype):
    """Logits and all four caches (self k/v over max_len slots, the
    cross k/v over the 16 frames), and K1's dispatcher called three
    times a decoder layer and once an encoder layer."""
    jm, jp, tm, tp = pair(dtype)
    toks, fr = tokens(jm.cfg, 2, 11), frames(jm.cfg, 2)
    jl, jcache, jlen = jax_prefill(jm, jp, toks, fr, 20)
    calls = []
    real = flash_ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    flash_ops.flash_attention = counting
    try:
        with torch.inference_mode():
            tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 20,
                                          frames=torch.from_numpy(fr))
    finally:
        flash_ops.flash_attention = real
    assert tl.shape == (2, 1, tm.cfg.vocab_size)
    assert tlen == int(jlen) == 11
    assert calls == ([(FRAMES, FRAMES, False)] * tm.cfg.n_enc_layers
                     + [(11, 11, True), (11, FRAMES, False)]
                     * tm.cfg.n_layers)
    close(jl, tl, dtype)
    close_cache(jcache, tcache, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_reference(dtype):
    """6 greedy decode steps after a 9-token prefill: each step's logits
    and, at the end, all four caches; each new token embedded at
    sinusoidal position 0, as the reference does."""
    jm, jp, tm, tp = pair(dtype)
    toks, fr = tokens(jm.cfg, 2, 9, seed=3), frames(jm.cfg, 2, seed=4)
    jl, jcache, jlen = jax_prefill(jm, jp, toks, fr, 24)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 24,
                                      frames=torch.from_numpy(fr))
    step = jax.jit(jm.decode)
    nxt = argmax_tokens(jl)
    for _ in range(6):
        jl, jcache, jlen = step(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
        assert tlen == int(jlen)
        close(jl, tl, dtype)
        nxt = argmax_tokens(jl)
    assert tlen == 15
    close_cache(jcache, tcache, dtype)


def test_decode_embeds_at_position_zero():
    """The decode step's embedding is the token's plus the sinusoid of
    position 0 whatever ``length`` is; one embedded at position
    ``length`` instead moves the logits far past the f32 tolerance, so
    the comparisons above see where decode embeds."""
    jm, jp, tm, tp = pair("float32")
    toks, fr = tokens(jm.cfg, 2, 9, seed=3), frames(jm.cfg, 2, seed=4)
    jl, jcache, jlen = jax_prefill(jm, jp, toks, fr, 24)
    nxt = argmax_tokens(jl)
    want = jm.decode(jp, jcache, jnp.asarray(nxt), jlen)[0]
    tnxt = torch.from_numpy(nxt)
    with torch.inference_mode():
        emb = tm._embed_tokens(tp, tnxt)
        plain = torch.nn.functional.embedding(tnxt.long(),
                                              tp["embed"]["tokens"])
        assert torch.equal(emb, plain + tL.sinusoidal_positions(
            1, tm.cfg.d_model, "cpu"))
        _, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 24,
                                     frames=torch.from_numpy(fr))
        real = tm._embed_tokens
        tm._embed_tokens = lambda p, t, offset=0: real(p, t, offset=tlen)
        try:
            moved = tm.decode(tp, tcache, tnxt, tlen)[0]
        finally:
            del tm._embed_tokens
    err = np.abs(moved.numpy() - np.asarray(want)).max()
    assert err > 100 * TOL["float32"]["atol"], err


def test_decode_past_max_len_matches_reference():
    """An 8-token prompt into a self cache of 8 slots, then two decode
    steps: the reference clamps each write to the last slot
    (dynamic_update_slice) and attends over every slot; the port the
    same, f32 at 2e-5."""
    jm, jp, tm, tp = pair("float32")
    toks, fr = tokens(jm.cfg, 2, 8, seed=6), frames(jm.cfg, 2, seed=7)
    jl, jcache, jlen = jax_prefill(jm, jp, toks, fr, 8)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 8,
                                      frames=torch.from_numpy(fr))
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
    assert tcache["k"].shape[2] == 8
    close_cache(jcache, tcache, "float32")


def test_published_widths_prefill_decode_match_reference():
    """whisper-tiny at its published widths (d_model 384, 6 heads of 64,
    vocab 51865, d_ff 1536), cut to 1 encoder and 1 decoder layer, 32
    frames, f32: prefill's logits and caches and 3 decode steps."""
    jm, jp, tm, tp = pair("float32", wide=True)
    assert (tm.cfg.d_model, tm.cfg.n_heads, tm.cfg.resolved_head_dim,
            tm.cfg.vocab_size) == (384, 6, 64, 51865)
    toks, fr = tokens(jm.cfg, 2, 13, seed=8), frames(jm.cfg, 2, 32, seed=9)
    jl, jcache, jlen = jax_prefill(jm, jp, toks, fr, 24)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 24,
                                      frames=torch.from_numpy(fr))
    close(jl, tl, "float32")
    close_cache(jcache, tcache, "float32")
    step = jax.jit(jm.decode)
    nxt = argmax_tokens(jl)
    for _ in range(3):
        jl, jcache, jlen = step(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
        assert tlen == int(jlen)
        close(jl, tl, "float32")
        nxt = argmax_tokens(jl)


def batch_np(cfg, b, s, seed=10, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
           "frames": rng.standard_normal(
               (b, FRAMES, cfg.d_model)).astype(np.float32)}
    if mask:
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


@pytest.mark.parametrize("dtype,mask", [("float32", False),
                                        ("float32", True),
                                        ("bfloat16", False)])
def test_loss_and_grads_match_reference(dtype, mask):
    """``loss`` and every gradient leaf against ``jax.value_and_grad`` of
    the reference's loss: the loss within the dtype's tolerance
    (relative), an aux loss of 0, each leaf within GRAD_REL of its
    largest |g|, in the params' dtype."""
    jm, jp, tm, tp = pair(dtype)
    batch = batch_np(jm.cfg, 2, 12, mask=mask)
    (jloss, jmetrics), jg = jax.jit(jax.value_and_grad(jm.loss,
                                                       has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = {k: np.asarray(v, np.float32) for k, v in _flatten(jg)}
    loss, metrics, grads = value_and_grad(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=TOL[dtype]["rtol"])
    np.testing.assert_allclose(metrics["xent"].item(),
                               float(jmetrics["xent"]),
                               rtol=TOL[dtype]["rtol"])
    assert metrics["aux_loss"].item() == float(jmetrics["aux_loss"]) == 0.0
    assert set(jgrads) == {p for p, _ in T.flatten(grads)}
    for path, g in T.flatten(grads):
        assert g.dtype == tm.dtype and tuple(g.shape) == jgrads[path].shape
        want = jgrads[path]
        err = np.abs(g.float().numpy() - want).max()
        assert err <= GRAD_REL[dtype] * max(np.abs(want).max(), 1e-30), \
            (path, err, np.abs(want).max())


def test_loss_recomputes_each_decoder_layer():
    """Each decoder layer runs under activation checkpointing: K1's
    dispatcher is called once an encoder layer and twice a decoder layer
    per attention in a gradient (the forward and its recompute)."""
    jm, jp, tm, tp = pair("float32")
    batch = batch_np(jm.cfg, 2, 12)
    calls = []
    real = flash_ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append(kw["causal"])
        return real(q, k, v, **kw)

    flash_ops.flash_attention = counting
    try:
        value_and_grad(tm, tp, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    finally:
        flash_ops.flash_attention = real
    n_enc, n_dec = tm.cfg.n_enc_layers, tm.cfg.n_layers
    assert len(calls) == n_enc + 2 * 2 * n_dec
    assert calls.count(True) == 2 * n_dec


def test_init_cache_shapes():
    cfg = torch_smoke(ARCH)
    tm = torch_build(cfg)
    hd = cfg.resolved_head_dim
    cache = tm.init_cache(3, 40, "meta")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "k": (2, 3, 40, 4, hd), "v": (2, 3, 40, 4, hd),
        "ck": (2, 3, 1500, 4, hd), "cv": (2, 3, 1500, 4, hd)}
    assert all(v.dtype == tm.dtype for v in cache.values())
    small = tm.init_cache(1, 8, "cpu", s_enc=16, extra=2)
    assert small["k"].shape[2] == 10 and small["ck"].shape[2] == 16
    assert not any(v.any() for v in small.values())


def test_prefill_takes_patch_embeds_and_raises_without_frames():
    """``patch_embeds`` stands in for frames, as in the reference; with
    neither, prefill raises a ValueError that names them."""
    jm, jp, tm, tp = pair("float32")
    toks, fr = tokens(jm.cfg, 1, 5), frames(jm.cfg, 1)
    with torch.inference_mode():
        a = tm.prefill(tp, torch.from_numpy(toks), 8,
                       frames=torch.from_numpy(fr))[0]
        b = tm.prefill(tp, torch.from_numpy(toks), 8,
                       patch_embeds=torch.from_numpy(fr))[0]
        assert torch.equal(a, b)
        with pytest.raises(ValueError, match="frames.*patch_embeds"):
            tm.prefill(tp, torch.from_numpy(toks), 8)
