"""The PyTorch port's multi-head latent attention (MLA) and multi-token
prediction (MTP) against the reference JAX package, on deepseek-v3-671b's
smoke config (2 layers, d_model 64, 4 heads, q_lora 32, kv_lora 16,
nope/rope/v 16/8/16, 8 experts top-2 plus 1 shared, MTP depth 1).

The same weights (the reference's ``init`` through the bridge) and the
same inputs (numpy seeds) go through both packages: each MLA function,
``DecoderLM.prefill`` and ``decode`` (logits and the latent caches), decode
past ``max_len``, and ``loss`` with MTP and its gradients.  f32 at the
reference kernel tests' 2e-5, bf16 at 5e-2.  Prefill attention reaches
K1's dispatcher, which takes its plain version on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import common as tC  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402
from repro_torch.training.step import value_and_grad  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
DTYPES = ["float32", "bfloat16"]


def pair(dtype, seed=0, **edit):
    """(jax model, jax params, torch model, bridged torch params)."""
    jm = jax_build(get_smoke(ARCH).replace(dtype=dtype, **edit))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = torch_build(torch_smoke(ARCH).replace(dtype=dtype, **edit))
    return jm, jp, tm, params_from_flat(
        {k: np.asarray(v) for k, v in _flatten(jp)})


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **TOL[dtype])


def layer_attn(jp, tp, l=0):
    """Layer ``l``'s MLA params on both sides."""
    return ({k: v[l] for k, v in jp["layers"]["attn"].items()},
            {k: v[l] for k, v in tp["layers"]["attn"].items()})


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_functions_match_reference(dtype):
    """mla_latents, mla_queries, mla_prefill (output and latents) and
    mla_decode (against a latent cache of 10 filled slots out of 16, the
    new token's latents written at slot 9) on the same activations."""
    jm, jp, tm, tp = pair(dtype)
    cfg = jm.cfg
    jap, tap = layer_attn(jp, tp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jm.dtype)
    tx = torch.from_numpy(x).to(tm.dtype)
    jpos = jnp.arange(10)[None, :]
    tpos = torch.arange(10)[None, :]
    with torch.inference_mode():
        for j, t in zip(jA.mla_latents(jx, jap, cfg, jpos),
                        tA.mla_latents(tx, tap, tm.cfg, tpos)):
            assert t.dtype == tm.dtype and t.shape == j.shape
            close(j, t, dtype)
        for j, t in zip(jA.mla_queries(jx, jap, cfg, jpos),
                        tA.mla_queries(tx, tap, tm.cfg, tpos)):
            assert t.shape == j.shape
            close(j, t, dtype)
        jo, (jc, jr) = jA.mla_prefill(jx, jap, cfg, jpos)
        to, tc, tr = tA.mla_prefill(tx, tap, tm.cfg, tpos)
        assert to.shape == jo.shape == (2, 10, cfg.d_model)
        for j, t in ((jo, to), (jc, tc), (jr, tr)):
            close(j, t, dtype)
        # decode the last token against the cache of the first 9 plus its
        # own latents, as DecoderLM does
        S = 16
        jckv = jnp.zeros((2, S, cfg.mla.kv_lora_rank), jm.dtype)
        jckv = jckv.at[:, :10].set(jc)
        jkr = jnp.zeros((2, S, cfg.mla.qk_rope_head_dim), jm.dtype)
        jkr = jkr.at[:, :10].set(jr)
        jd = jA.mla_decode(jx[:, 9:], jap, cfg, jckv, jkr, 10,
                           jnp.full((2, 1), 9, jnp.int32))
        td = tA.mla_decode(tx[:, 9:], tap, tm.cfg,
                           torch.from_numpy(np.array(jckv, np.float32)).to(
                               tm.dtype),
                           torch.from_numpy(np.array(jkr, np.float32)).to(
                               tm.dtype), 10, torch.full((2, 1), 9))
    assert td.shape == jd.shape == (2, 1, cfg.d_model)
    assert td.dtype == tm.dtype
    close(jd, td, dtype)
    # the absorbed decode of the last token is the expanded prefill's last
    # row
    close(jo[:, 9:], td, dtype)


def test_mla_rms_is_its_own_norm():
    """MLA's norm takes eps 1e-6 and a bare scale vector, not the model's
    norm_eps and {"scale": ...}: with a norm_eps of 1e-5 the two differ
    where the variance is small, and the port's follows the reference's."""
    x = np.random.default_rng(4).standard_normal((3, 16)).astype(
        np.float32) * 1e-3
    scale = np.linspace(0.5, 1.5, 16).astype(np.float32)
    j = jA._rms(jnp.asarray(x), jnp.asarray(scale))
    t = tA._rms(torch.from_numpy(x), torch.from_numpy(scale))
    close(j, t, "float32")
    other = tL.rmsnorm(torch.from_numpy(x), {"scale": torch.from_numpy(
        scale)}, 1e-5)
    assert (other - t).abs().max().item() > 1e-3


def record_router_gaps(monkeypatch):
    """Wraps the port's MoE router; returns a list that gets, for each
    call, every token's gap between its top_k-th and next router score
    (the scores top_k compares: sigmoid or logits), in bf16 ulps of the
    top_k-th score."""
    gaps = []
    real = tM.route

    def route(x_flat, router_w, m, router_mode):
        logits = (x_flat @ router_w).float()
        score = torch.sigmoid(logits) if router_mode == "sigmoid" else logits
        top = torch.sort(score, dim=-1, descending=True).values
        kth = top[:, m.top_k - 1]
        ulp = torch.exp2(torch.floor(torch.log2(kth.abs())) - 7)
        gaps.append(((kth - top[:, m.top_k]) / ulp).numpy())
        return real(x_flat, router_w, m, router_mode)

    monkeypatch.setattr(tM, "route", route)
    return gaps


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_decode_match_reference(dtype, monkeypatch):
    """Prefill logits and the ckv/krope caches, then 3 decode steps' logits
    and caches, each against the reference's.

    In bf16 a token whose top_k-th and next router scores lie within 2
    bf16 ulps can take the other expert on one side (the two packages
    round the layer's activations differently), and its row then moves by
    O(1) from that step on.  Such a row leaves the comparison at the step
    where it moved, only if the port's router had that near tie for it
    in that step; at least one row must hold to the end.  f32 lets no row
    leave."""
    jm, jp, tm, tp = pair(dtype)
    b = 2
    toks = tokens(jm.cfg, b, 20)
    max_len = 28
    jl, jcache, jlen = jax.jit(lambda p, t: jm.prefill(p, t, max_len))(
        jp, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), max_len)
    assert tl.shape == (b, 1, jm.cfg.vocab_size) and tlen == int(jlen) == 20
    assert set(tcache) == set(jcache) == {"ckv", "krope"}
    for key in tcache:
        assert tcache[key].shape == jcache[key].shape
        assert tcache[key].dtype == tm.dtype
        close(jcache[key], tcache[key], dtype)
    close(jl, tl, dtype)
    gaps = record_router_gaps(monkeypatch)
    step = jax.jit(jm.decode)
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    held = list(range(b))
    for _ in range(3):
        jl, jcache, jlen = step(jp, jcache, jnp.asarray(nxt), jlen)
        gaps.clear()
        with torch.inference_mode():
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
        assert tlen == int(jlen) and len(gaps) == tm.cfg.n_layers
        near_tie = np.min(gaps, axis=0) <= 2.0
        for row in list(held):
            want = np.asarray(jl[row], np.float32)
            if not np.allclose(tl[row].float().numpy(), want,
                               **TOL[dtype]):
                assert dtype == "bfloat16" and near_tie[row], (
                    f"row {row} moved without a router near tie")
                held.remove(row)
        assert held
        close(jl[np.array(held)], tl[held], dtype)
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for key in tcache:
        close(jcache[key][:, np.array(held)], tcache[key][:, held], dtype)


def test_decode_past_max_len_matches_reference():
    """An 8-token prompt into a cache of max_len 8, then two decode steps:
    the reference's dynamic_update_slice clamps each latent write to the
    last slot and the mask admits every slot; the port does the same."""
    jm, jp, tm, tp = pair("float32")
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
    for key in ("ckv", "krope"):
        assert tcache[key].shape[2] == 8
        close(jcache[key], tcache[key], "float32")


def full_logits(model, params, toks):
    """Logits at every position from one cache-free forward."""
    x = tC.embed(toks, params["embed"], model.cfg)
    pos = torch.arange(x.shape[1])[None, :]
    x = model._run_layers(x, params, pos, None, None, "train")[0]
    x = tL.apply_norm(x, params["final_norm"], model.cfg)
    return tC.lm_logits(x, params["embed"], model.cfg)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 5e-2),
                                       ("float32", 2e-5)])
def test_decode_matches_prefill(dtype, tol):
    """Teacher-forced decode (absorbed MLA against the latent cache)
    reproduces the logits of one expanded forward over the whole sequence.
    bf16 at 5e-2, not the dense check's 2e-2: the expanded form rounds
    k_nope, v and q to bf16 where the absorbed one stays in f32, and the
    reference's own two forms differ by up to 0.045 on this config's
    weights (its bf16 prefill against its decode, the same 12 tokens).
    The capacity factor is n_experts / top_k, so that no token drops in
    either."""
    import dataclasses
    cfg = torch_smoke(ARCH).replace(dtype=dtype)
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    tm = torch_build(cfg)
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(tokens(cfg, 1, 12))
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


def batch_np(cfg, b, s, seed=1, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


@pytest.mark.parametrize("mask", [False, True], ids=["no-mask", "mask"])
def test_loss_with_mtp_and_grads_match_reference(mask):
    """``loss`` with MTP in f32: the loss, xent, aux loss and
    ``metrics["mtp"]`` within 2e-5, and every gradient leaf (``mtp/*``
    included) within 2e-5 elementwise of ``jax.value_and_grad``'s.  With
    a loss mask: the main loss takes it, the MTP loss does not."""
    jm, jp, tm, tp = pair("float32")
    batch = batch_np(jm.cfg, 2, 16, mask=mask)
    (jloss, jmetrics), jg = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    jgrads = {k: np.asarray(v) for k, v in _flatten(jg)}
    loss, metrics, grads = value_and_grad(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(metrics) == set(jmetrics) == {"xent", "aux_loss", "mtp"}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    for key in metrics:
        np.testing.assert_allclose(metrics[key].item(),
                                   float(jmetrics[key]), rtol=2e-5)
    assert metrics["mtp"].item() > 0
    paths = {p for p, _ in T.flatten(grads)}
    assert paths == set(jgrads)
    assert any(p.startswith("mtp/layer/attn/") for p in paths)
    for path, g in T.flatten(grads):
        assert g.dtype == torch.float32 and g.shape == jgrads[path].shape
        np.testing.assert_allclose(g.numpy(), jgrads[path],
                                   err_msg=path, **TOL["float32"])
    for path in ("mtp/proj", "mtp/norm/scale", "mtp/layer/attn/wkv_a"):
        assert np.abs(jgrads[path]).max() > 0, path


def test_mtp_loss_reproduces_the_reference_quirks(monkeypatch):
    """The MTP layer runs once, without remat, with the last layer's
    window and theta, and its MoE aux loss is dropped: the loss is
    (xent + 0.3 mtp) + the stack's aux loss alone, and the layers under
    remat run twice each (forward and recompute) while the MTP layer runs
    once in the forward and not again in the backward."""
    _, _, tm, tp = pair("float32")
    batch = {k: torch.from_numpy(v)
             for k, v in batch_np(tm.cfg, 2, 12, seed=5).items()}
    calls = []
    real = flash_ops.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention", counted)
    loss, metrics, _ = value_and_grad(tm, tp, batch)
    n = tm.cfg.n_layers
    assert len(calls) == 2 * n + 1
    want = (metrics["xent"] + 0.3 * metrics["mtp"]) + metrics["aux_loss"]
    assert torch.equal(loss, want)
    with torch.no_grad():
        h = tm._embed_inputs(tp, batch["tokens"])
        pos = torch.arange(h.shape[1])[None, :]
        _, aux = tm._run_layers(h, tp, pos, None, None, "train")
    assert torch.equal(aux, metrics["aux_loss"])


def test_param_tree_matches_reference():
    """The port's params carry exactly the reference's paths, shapes and
    dtypes (``layers/attn/wq_a``, ..., ``mtp/proj``,
    ``mtp/layer/attn/wkv_a``, ``mtp/norm/scale``): on the smoke config,
    drawn on both sides, and on a 1-layer full-width cut against the
    reference's ``jax.eval_shape`` of its ``init`` (the port's drawn on
    the meta device, by its default generator)."""
    jm, jp, tm, _ = pair("bfloat16")
    want = {p: (tuple(v.shape), str(v.dtype)) for p, v in _flatten(jp)}
    got = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for p, v in T.flatten(tm.init(torch.Generator().manual_seed(0),
                                         "cpu"))}
    assert got == want
    cut = dict(n_layers=1)
    shapes = jax.eval_shape(jax_build(jax_config(ARCH).replace(**cut)).init,
                            jax.random.PRNGKey(0))
    want = {p: tuple(v.shape) for p, v in _flatten(shapes)}
    full = torch_build(get_config(ARCH).replace(**cut))
    got = {p: tuple(v.shape) for p, v in T.flatten(
        full.init(None, "meta"))}
    assert got == want
    assert got["mtp/proj"] == (2 * 7168, 7168)
    assert got["layers/attn/wq_b"] == (1, 1536, 128 * 192)


@pytest.mark.parametrize("edit", [
    {}, dict(n_layers=2, mtp_depth=0), dict(n_layers=1, mtp_depth=0),
    dict(n_layers=1)], ids=["published", "serving-cut", "decode-cut",
                            "one-layer-mtp"])
def test_every_config_builds(edit):
    """DecoderLM builds the published config and its full-width cuts (no
    MLA/MTP raise), and its latent cache has the reference's layout."""
    cfg = get_config(ARCH).replace(**edit)
    model = torch_build(cfg)
    cache = model.init_cache(4, 2048, "meta")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "ckv": (cfg.n_layers, 4, 2048, 512),
        "krope": (cfg.n_layers, 4, 2048, 64)}
    assert model.router_mode == "sigmoid"
