"""The PyTorch port's training path against the reference JAX package on
the CPU: ``DecoderLM.loss``, ``RWKVLM.loss`` and ``JambaLM.loss`` and
their gradients against ``jax.value_and_grad(model.loss)`` on smoke
configs (RWKV and Jamba in bf16 too, Jamba's dense 2-layer cut), short
trajectories of the train step, microbatch accumulation, the MoE aux
loss and the f32-output expert product's gradient, and remat.

Weights are the reference's ``init`` carried by the bridge; tokens come
from numpy.  Tolerances (f32): the loss within 2e-5 relative, as the
forward tests; each gradient leaf within 1e-4 of the leaf's largest |g|
(the backward sums over every token, in another order on each side, and
the port's attention gradient is the explicit formula where the
reference differentiates its blockwise twin), and a test shows that
limit catches an attention gradient with its D term dropped.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import cosine as jcosine  # noqa: E402
from repro.training.step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.checks import \
    attention_bwd_faulty  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig, cosine  # noqa: E402
from repro_torch.training.step import (make_train_step,  # noqa: E402
                                       value_and_grad)

LOSS_RTOL = 2e-5
GRAD_REL = 1e-4
JAMBA = "jamba-1.5-large-398b"


def no_drop(cfg):
    """MoE capacity large enough that no token drops on either side."""
    if cfg.moe is None:
        return cfg
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=16.0))


def dense_cut(cfg):
    """Jamba's 2-layer training cut of chip_smoke.py: attention + MLP,
    then Mamba + MLP (an MoE layer offset no layer of the period has)."""
    import dataclasses
    return cfg.replace(n_layers=2, attn_layer_period=2, attn_layer_offset=0,
                       moe=dataclasses.replace(cfg.moe, layer_offset=2))


@functools.lru_cache(maxsize=None)
def pair(arch, edit=None):
    """(jax model, jax params, torch model, bridged torch params), f32."""
    jcfg = get_smoke(arch).replace(dtype="float32")
    tcfg = torch_smoke(arch).replace(dtype="float32")
    if edit is not None:
        jcfg, tcfg = edit(jcfg), edit(tcfg)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(tcfg)
    return jm, jp, tm, params_from_flat(
        {k: np.asarray(v) for k, v in _flatten(jp)})


def batch_np(cfg, b, s, seed=1, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def jax_value_and_grad(jm, jp, batch):
    (loss, metrics), g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), metrics, {k: np.asarray(v) for k, v in _flatten(g)}


def grad_ratios(jgrads, tgrads):
    """{leaf: max |port - reference| / (GRAD_REL x max |reference|)};
    a leaf passes at <= 1."""
    out = {}
    for path, g in T.flatten(tgrads):
        want = jgrads[path]
        err = np.abs(g.detach().numpy() - want).max()
        out[path] = err / (GRAD_REL * max(np.abs(want).max(), 1e-30))
    return out


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,seq,mask", [
    ("minicpm-2b", 24, False),
    ("mistral-nemo-12b", 24, True),        # GQA: 4 query / 2 KV heads
    ("h2o-danube-3-4b", 40, False),        # window 16 bites past 32
    ("rwkv6-1.6b", 24, False),             # K2's recurrence, remat'ed
    ("rwkv6-1.6b", 40, True),
    (JAMBA, 24, False),                    # K3's scan and MoE, by period
    (JAMBA, 40, True),
])
def test_loss_and_grads_match_reference(arch, seq, mask):
    jm, jp, tm, tp = pair(arch)
    batch = batch_np(jm.cfg, 2, seq, mask=mask)
    jloss, jmetrics, jgrads = jax_value_and_grad(jm, jp, batch)
    loss, metrics, grads = value_and_grad(tm, tp, to_torch(batch))
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["xent"].item(),
                               float(jmetrics["xent"]), rtol=LOSS_RTOL)
    assert set(jgrads) == {p for p, _ in T.flatten(grads)}
    for path, g in T.flatten(grads):
        assert g.dtype == torch.float32 and g.shape == jgrads[path].shape
    ratios = grad_ratios(jgrads, grads)
    assert max(ratios.values()) <= 1.0, ratios


def gemma_hd256_cut(cfg):
    """gemma3-4b's smoke config at its published head dim 256, cut to 2
    layers: a local one (window 16) and a global one."""
    return cfg.replace(head_dim=256, n_layers=2, local_global_period=2)


def test_gemma_hd256_cut_loss_and_grads_match_reference():
    """gemma3-4b's smoke config at head dim 256 (K1's backward above 128
    on the card), one local and one global layer, 40 tokens past the
    window 16: loss and every gradient leaf against the reference."""
    jm, jp, tm, tp = pair("gemma3-4b", gemma_hd256_cut)
    assert tm.cfg.head_dim == 256
    assert tT.layer_scalars(tm.cfg)[0] == [16, 0]
    batch = batch_np(jm.cfg, 2, 40)
    jloss, _, jgrads = jax_value_and_grad(jm, jp, batch)
    loss, _, grads = value_and_grad(tm, tp, to_torch(batch))
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    assert set(jgrads) == {p for p, _ in T.flatten(grads)}
    ratios = grad_ratios(jgrads, grads)
    assert max(ratios.values()) <= 1.0, ratios


def test_rwkv_bf16_loss_and_grads_match_reference():
    """rwkv6-1.6b smoke in bf16 on both sides (weights, activations and
    gradients; the recurrence, decay and norms in f32 on both): the loss
    and every gradient leaf within the reference's bf16 tolerance, 5e-2
    relative and of the leaf's largest |g|."""
    jcfg = get_smoke("rwkv6-1.6b")
    tcfg = torch_smoke("rwkv6-1.6b")
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    tm = torch_build(tcfg)
    tp = params_from_flat({k: np.asarray(v) for k, v in _flatten(jp)})
    batch = batch_np(jcfg, 2, 24, seed=7)
    jloss, _, jgrads = jax_value_and_grad(jm, jp, batch)
    loss, _, grads = value_and_grad(tm, tp, to_torch(batch))
    np.testing.assert_allclose(loss.item(), jloss, rtol=5e-2)
    for path, g in T.flatten(grads):
        assert g.dtype == torch.bfloat16, path
        want = jgrads[path].astype(np.float32)
        err = np.abs(g.float().numpy() - want).max()
        assert err <= 5e-2 * max(np.abs(want).max(), 1e-30), path


def param_dtype(params, path):
    """The dtype of the leaf at ``path`` ("a/b/c") of a nested dict."""
    node = params
    for key in path.split("/"):
        node = node[key]
    return node.dtype


def test_jamba_bf16_loss_and_grads_match_reference():
    """jamba-1.5-large-398b in bf16 on both sides (the scan, dt, A and D
    in f32 on both; expert products with f32 outputs).  The smoke config
    (8 layers, MoE on every other): the loss and the aux loss within 5e-2
    relative.  Its gradients are not compared: at 8 layers bf16 rounding
    moves them by 26-67% of a leaf's largest |g| from the f32 gradients
    of the same weights on both sides, the reference's included (seeds 2
    and 5), so no limit between the two holds there.  The dense 2-layer
    cut that chip_smoke.py trains, where each side is within 2.6-3.6% of
    f32: the loss and every gradient leaf within the reference's bf16
    tolerance, 5e-2 relative and of the leaf's largest |g|."""
    for edit in (no_drop, dense_cut):
        jcfg = edit(get_smoke(JAMBA))
        tcfg = edit(torch_smoke(JAMBA))
        assert jcfg.dtype == tcfg.dtype == "bfloat16"
        jm = jax_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(2))
        tm = torch_build(tcfg)
        tp = params_from_flat({k: np.asarray(v) for k, v in _flatten(jp)})
        batch = batch_np(jcfg, 2, 24, seed=7)
        jloss, jmetrics, jgrads = jax_value_and_grad(jm, jp, batch)
        loss, metrics, grads = value_and_grad(tm, tp, to_torch(batch))
        np.testing.assert_allclose(loss.item(), jloss, rtol=5e-2)
        np.testing.assert_allclose(metrics["aux_loss"].item(),
                                   float(jmetrics["aux_loss"]), rtol=5e-2)
        if edit is no_drop:
            assert metrics["aux_loss"].item() > 0
            continue
        for path, g in T.flatten(grads):
            assert g.dtype == param_dtype(tp, path), path
            if g.numel() == 0:
                continue
            want = jgrads[path].astype(np.float32)
            err = np.abs(g.float().numpy() - want).max()
            assert err <= 5e-2 * max(np.abs(want).max(), 1e-30), path


def test_jamba_dense_cut_matches_reference():
    """Jamba's dense cut (no MoE layer: its MoE stack is empty on both
    sides) at smoke widths: loss, a zero aux loss and every gradient leaf
    match the reference; the empty leaves' gradients are empty zeros."""
    jm, jp, tm, tp = pair(JAMBA, dense_cut)
    assert tm.moe_js == [] and tm.mlp_js == [0, 1]
    batch = batch_np(jm.cfg, 2, 24, seed=12)
    jloss, jmetrics, jgrads = jax_value_and_grad(jm, jp, batch)
    loss, metrics, grads = value_and_grad(tm, tp, to_torch(batch))
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    assert metrics["aux_loss"].item() == float(jmetrics["aux_loss"]) == 0.0
    assert set(jgrads) == {p for p, _ in T.flatten(grads)}
    empty = {p for p, g in T.flatten(grads) if g.numel() == 0}
    assert empty == {f"periods/moe/{w}" for w in ("router", "gate", "up",
                                                   "down")}
    for path, g in T.flatten(grads):
        assert g.shape == jgrads[path].shape, path
        if path not in empty:
            err = np.abs(g.numpy() - jgrads[path]).max()
            assert err <= GRAD_REL * np.abs(jgrads[path]).max(), path


def test_jamba_trajectory_matches_reference():
    """Three steps of the train step for jamba-1.5-large-398b smoke
    (AdamW, cosine, clip; the MoE aux loss in the loss) from the same
    weights on the same stream: every loss within 1e-4 relative, as for
    minicpm-2b and rwkv6-1.6b."""
    jm, jp, tm, tp = pair(JAMBA)
    sched = dict(peak_lr=3e-3, warmup=2, total=3)
    jopt = JAdamW(lambda s: jcosine(s, **sched), JAdamWConfig(
        weight_decay=0.01))
    opt = AdamW(lambda s: cosine(s, **sched), AdamWConfig(weight_decay=0.01))
    jstep = jax.jit(jax_train_step(jm, jopt))
    step = make_train_step(tm, opt)
    jstate, state = jopt.init(jp), opt.init(tp)
    tp = T.map_tree(torch.clone, tp)
    data = SyntheticLMDataset(tm.cfg.vocab_size, 24, 2, seed=1)
    for i in range(3):
        hb = data.batch_at(i)
        jp, jstate, jm_ = jstep(jp, jstate, {k: jnp.asarray(v)
                                            for k, v in hb.items()})
        tp, state, m = step(tp, state, to_torch(hb))
        np.testing.assert_allclose(m["loss"].item(), float(jm_["loss"]),
                                   rtol=1e-4)
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_bmm_f32_backward_formula_matches_jax_vjp():
    """The card's f32-output expert product's backward (``bmm_f32_grads``:
    the f32 cotangent against the other operand, rounded to the operand's
    bf16) against ``jax.vjp`` of the reference's einsum with
    ``preferred_element_type=f32``: bf16 gradients within one bf16 ulp
    (2^-8 relative; both sides sum the same f32 products in other orders
    and round once), most of them equal; and against torch autograd of
    the CPU's product of converted operands."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((3, 10, 32)).astype(np.float32)
    w = (rng.standard_normal((3, 32, 48)) * 0.25).astype(np.float32)
    g = rng.standard_normal((3, 10, 48)).astype(np.float32)
    ja, jw = jnp.asarray(a, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    _, vjp = jax.vjp(lambda x, y: jnp.einsum(
        "ecd,edf->ecf", x, y, preferred_element_type=jnp.float32), ja, jw)
    want = [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g))]
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).bfloat16()
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).bfloat16()
    got = tM.bmm_f32_grads(ta, tw, torch.from_numpy(g))
    leaves = [ta.clone().requires_grad_(), tw.clone().requires_grad_()]
    auto = torch.autograd.grad(tM._bmm_f32(*leaves), leaves,
                               torch.from_numpy(g))
    for x, y, wnt in zip(got, auto, want):
        assert x.dtype == torch.bfloat16
        xf = x.float().numpy()
        np.testing.assert_allclose(xf, wnt, rtol=2 ** -8,
                                   atol=2 ** -8 * np.abs(wnt).max())
        assert (xf == wnt).mean() > 0.9
        assert torch.equal(x, y)


def test_rwkv_trajectory_matches_reference():
    """Five steps of the train step for rwkv6-1.6b smoke (AdamW, cosine,
    clip) from the same weights on the same stream: every loss within
    1e-4 relative, as for minicpm-2b."""
    jm, jp, tm, tp = pair("rwkv6-1.6b")
    sched = dict(peak_lr=3e-3, warmup=2, total=5)
    jopt = JAdamW(lambda s: jcosine(s, **sched), JAdamWConfig(
        weight_decay=0.01))
    opt = AdamW(lambda s: cosine(s, **sched), AdamWConfig(weight_decay=0.01))
    jstep = jax.jit(jax_train_step(jm, jopt))
    step = make_train_step(tm, opt)
    jstate, state = jopt.init(jp), opt.init(tp)
    tp = T.map_tree(torch.clone, tp)
    data = SyntheticLMDataset(tm.cfg.vocab_size, 24, 2, seed=1)
    for i in range(5):
        hb = data.batch_at(i)
        jp, jstate, jm_ = jstep(jp, jstate, {k: jnp.asarray(v)
                                            for k, v in hb.items()})
        tp, state, m = step(tp, state, to_torch(hb))
        np.testing.assert_allclose(m["loss"].item(), float(jm_["loss"]),
                                   rtol=1e-4)
    assert int(state["step"]) == int(jstate["step"]) == 5


def test_rwkv_loss_returns_a_zero_aux_loss():
    """RWKVLM.loss returns (xent, {"xent", "aux_loss"}) with the aux loss
    an f32 0, as the reference; a loss mask weights the tokens."""
    _, _, tm, tp = pair("rwkv6-1.6b")
    batch = to_torch(batch_np(tm.cfg, 2, 12, seed=9, mask=True))
    with torch.no_grad():
        loss, metrics = tm.loss(tp, batch)
        unmasked, _ = tm.loss(tp, {k: v for k, v in batch.items()
                                   if k != "loss_mask"})
    assert metrics["aux_loss"].dtype == torch.float32
    assert metrics["aux_loss"].item() == 0.0
    assert torch.equal(loss, metrics["xent"])
    assert loss.item() != unmasked.item()


class _ExplicitAttention(torch.autograd.Function):
    """Attention on the CPU with the CUDA path's structure: a Function
    whose backward is the explicit formula (``attention_bwd_ref``), or
    that formula with a fault."""

    @staticmethod
    def forward(ctx, q, k, v, kw, fault):
        o = attention_ref(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o)
        ctx.kw, ctx.fault = kw, fault
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        if ctx.fault is None:
            grads = attention_bwd_ref(q, k, v, o, do, **ctx.kw)
        else:
            grads = attention_bwd_faulty(q, k, v, o, do, ctx.fault,
                                         **ctx.kw)
        return (*grads, None, None)


@pytest.mark.parametrize("fault", [None, "no-delta"])
def test_grad_limit_catches_a_broken_attention_gradient(monkeypatch, fault):
    """Through the explicit formula the model's gradients pass the limit;
    with its D term dropped the attention weights' fail it."""
    jm, jp, tm, tp = pair("minicpm-2b")
    batch = batch_np(jm.cfg, 2, 24, seed=3)
    _, _, jgrads = jax_value_and_grad(jm, jp, batch)
    monkeypatch.setattr(
        flash_ops, "flash_attention",
        lambda q, k, v, **kw: _ExplicitAttention.apply(q, k, v, kw, fault))
    _, _, grads = value_and_grad(tm, tp, to_torch(batch))
    ratios = grad_ratios(jgrads, grads)
    attn = {p: r for p, r in ratios.items() if p.startswith("layers/attn/w")
            and p[-1] in "qk"}
    if fault is None:
        assert max(ratios.values()) <= 1.0, ratios
    else:
        assert min(attn.values()) > 10.0, attn


def test_trajectory_matches_reference():
    """Five steps of the train step (AdamW, cosine, clip) from the same
    weights on the same stream: every loss within 1e-4 relative.  Adam's
    first steps are about sign(g), so the params drift apart by more than
    the gradients' rounding: the optimizer's own arithmetic is held to
    1e-6 on identical inputs (tests/test_torch_optim.py), here the
    whole loop is."""
    jm, jp, tm, tp = pair("minicpm-2b")
    sched = dict(peak_lr=3e-3, warmup=2, total=5)
    jopt = JAdamW(lambda s: jcosine(s, **sched), JAdamWConfig(
        weight_decay=0.01))
    opt = AdamW(lambda s: cosine(s, **sched), AdamWConfig(weight_decay=0.01))
    jstep = jax.jit(jax_train_step(jm, jopt))
    step = make_train_step(tm, opt)
    jstate, state = jopt.init(jp), opt.init(tp)
    tp = T.map_tree(torch.clone, tp)
    jdata = JaxDataset(jm.cfg.vocab_size, 24, 2, seed=1)
    data = SyntheticLMDataset(tm.cfg.vocab_size, 24, 2, seed=1)
    for i in range(5):
        hb = data.batch_at(i)
        for k, v in jdata.batch_at(i).items():
            np.testing.assert_array_equal(hb[k], v)
        jp, jstate, jm_ = jstep(jp, jstate, {k: jnp.asarray(v)
                                            for k, v in hb.items()})
        tp, state, m = step(tp, state, to_torch(hb))
        np.testing.assert_allclose(m["loss"].item(), float(jm_["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(m["lr"].item(), float(jm_["lr"]),
                                   rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 5


def test_microbatches_match_reference():
    """microbatches=2: the loss averaged over the halves and the norm of
    the f32-accumulated gradient equal the reference's (1e-5), and equal
    the whole batch's (the halves' means average to the batch mean)."""
    jm, jp, tm, tp = pair("minicpm-2b")
    batch = batch_np(jm.cfg, 4, 16, seed=4)
    jopt = JAdamW(lambda s: jcosine(s, peak_lr=1e-3, warmup=1, total=4))
    jout = jax.jit(jax_train_step(jm, jopt, microbatches=2))(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    outs = {}
    for mb in (1, 2):
        opt = AdamW(lambda s: cosine(s, peak_lr=1e-3, warmup=1, total=4))
        params = T.map_tree(torch.clone, tp)
        outs[mb] = make_train_step(tm, opt, microbatches=mb)(
            params, opt.init(params), to_torch(batch))[2]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(outs[2][key].item(), float(jout[2][key]),
                                   rtol=1e-5)
        np.testing.assert_allclose(outs[2][key].item(), outs[1][key].item(),
                                   rtol=1e-5)


def test_moe_aux_loss_matches_reference():
    """mixtral smoke (8 experts, top-2, window 16): the aux loss joins the
    loss, and loss, aux and gradients (the router's included) match."""
    jm, jp, tm, tp = pair("mixtral-8x7b", no_drop)
    batch = batch_np(jm.cfg, 2, 24, seed=5)
    jloss, jmetrics, jgrads = jax_value_and_grad(jm, jp, batch)
    loss, metrics, grads = value_and_grad(tm, tp, to_torch(batch))
    assert float(jmetrics["aux_loss"]) > 0
    np.testing.assert_allclose(metrics["aux_loss"].item(),
                               float(jmetrics["aux_loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        loss.item(), (metrics["xent"] + metrics["aux_loss"]).item(),
        rtol=1e-7)
    ratios = grad_ratios(jgrads, grads)
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("arch,edit", [
    ("mixtral-8x7b", no_drop), ("minicpm-2b", no_drop), (JAMBA, no_drop),
    (JAMBA, dense_cut)], ids=["mixtral-8x7b", "minicpm-2b", "jamba",
                              "jamba-dense-cut"])
def test_aux_loss_is_summed_only_in_training(arch, edit):
    """Serving's layer runs carry no aux loss (None, no per-layer adds);
    training's is the MoE's sum, or 0 for a dense model or Jamba's dense
    cut."""
    _, _, tm, tp = pair(arch, edit)
    toks = to_torch(batch_np(tm.cfg, 2, 24, seed=5))["tokens"]
    x = tm._embed_inputs(tp, toks)
    pos = torch.arange(x.shape[1])[None, :]
    cache = tm.init_cache(2, 24, "cpu")
    with torch.no_grad():
        _, aux_prefill = tm._run_layers(x, tp, pos, cache, None, "prefill")
        _, aux_decode = tm._run_layers(x[:, :1], tp, None, cache, 23,
                                       "decode")
        _, aux_train = tm._run_layers(x, tp, pos, None, None, "train")
    assert aux_prefill is None and aux_decode is None
    assert aux_train.dtype == torch.float32
    has_moe = tm.cfg.moe is not None and getattr(tm, "moe_js", True) != []
    assert (aux_train.item() > 0) == has_moe


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_gives_the_same_bits(policy):
    """Each layer under activation checkpointing (whole-layer recompute,
    or keeping the matrix products' outputs) gives the loss and gradients
    of the same layers without it, bit for bit, and recomputes the
    attention once a layer in the backward."""
    _, _, tm, tp = pair("mistral-nemo-12b")
    batch = to_torch(batch_np(tm.cfg, 2, 20, seed=6))
    calls = []
    real = flash_ops.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    class NoRemat(type(tm)):
        def _run_layers(self, *a, remat=False):
            return super()._run_layers(*a, remat=False)

    tm.remat_policy = policy
    try:
        flash_ops.flash_attention = counted
        loss, _, grads = value_and_grad(tm, tp, batch)
        n_remat = len(calls)
        loss0, _, grads0 = value_and_grad(NoRemat(tm.cfg), tp, batch)
    finally:
        flash_ops.flash_attention = real
        tm.remat_policy = None
    assert n_remat == 2 * tm.cfg.n_layers
    assert len(calls) - n_remat == tm.cfg.n_layers
    assert torch.equal(loss, loss0)
    for (path, g), g0 in zip(T.flatten(grads), T.leaves(grads0)):
        assert torch.equal(g, g0), path


def record_saved_dots(monkeypatch):
    """Wraps remat policy "dots"' choice; returns the list of ops it told
    to save."""
    from repro_torch.models import transformer as tT
    saved = []
    real = tT._save_dots

    def save_dots(ctx, op, *a, **kw):
        out = real(ctx, op, *a, **kw)
        if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return out

    monkeypatch.setattr(tT, "_save_dots", save_dots)
    return saved


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_remat_dots_gives_the_same_bits_with_moe(arch, monkeypatch):
    """On MoE smoke configs (mixtral's softmax router; DeepSeek-V3's
    sigmoid router, shared expert, MLA and MTP), the loss and gradients
    under remat policy "dots" equal those without remat, bit for bit, and
    "dots" saves the expert products (on the CPU a bmm of f32 copies; on
    the card ``aten.bmm.dtype``, which ``_DOTS`` holds as jax's
    ``checkpoint_dots`` saves every dot_general)."""
    from repro_torch.models import transformer as tT
    assert torch.ops.aten.bmm.dtype in tT._DOTS
    _, _, tm, tp = pair(arch, no_drop)
    batch = to_torch(batch_np(tm.cfg, 2, 16, seed=9))

    class NoRemat(type(tm)):
        def _run_layers(self, *a, remat=False):
            return super()._run_layers(*a, remat=False)

    loss0, _, grads0 = value_and_grad(NoRemat(tm.cfg), tp, batch)
    saved = record_saved_dots(monkeypatch)
    tm.remat_policy = "dots"
    try:
        loss, _, grads = value_and_grad(tm, tp, batch)
    finally:
        tm.remat_policy = None
    assert torch.ops.aten.bmm.default in saved
    assert torch.equal(loss, loss0)
    for (path, g), g0 in zip(T.flatten(grads), T.leaves(grads0)):
        assert torch.equal(g, g0), path


def test_jamba_remat_takes_no_policy(monkeypatch):
    """As the reference's JambaLM checkpoints each period with no policy
    whatever remat_policy says, the port's recomputes every period whole:
    "dots" saves nothing there, and the gradients are those without
    remat, bit for bit."""
    _, _, tm, tp = pair(JAMBA, no_drop)
    batch = to_torch(batch_np(tm.cfg, 2, 16, seed=10))
    loss0, _, grads0 = value_and_grad(tm, tp, batch)
    saved = record_saved_dots(monkeypatch)
    tm.remat_policy = "dots"
    try:
        loss, _, grads = value_and_grad(tm, tp, batch)
    finally:
        tm.remat_policy = None
    assert saved == []
    assert torch.equal(loss, loss0)
    for (path, g), g0 in zip(T.flatten(grads), T.leaves(grads0)):
        assert torch.equal(g, g0), path


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_recomputes_the_saved_lse(monkeypatch, policy):
    """On the "hopper" route the forward's LSE is saved through
    save_for_backward, so a layer under activation checkpointing (policy
    None or "dots") hands its backward the LSE of the recompute: each
    backward gets the LSE of the q, k it gets, and the gradients equal
    those without remat, bit for bit.  The kernels are CPU stand-ins that
    call ref.py, and the route is forced to "hopper": this tests the
    routing, not the kernels."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import kernel_bwd as fkb
    from repro_torch.kernels.flash_attention import ref as fref
    calls = []

    def forward(q, k, v, variant, *, causal, window, softcap, lse=None):
        kw = dict(causal=causal, window=window, softcap=softcap)
        if lse is not None:
            lse[..., :q.shape[1]] = fref.attention_lse(q, k, **kw)
        return fref.attention_ref(q, k, v, **kw)

    def backward(q, k, v, o, do, variant, *, lse=None, **kw):
        calls.append((variant, torch.equal(
            lse[..., :q.shape[1]], fref.attention_lse(q, k, **kw))))
        return fref.attention_bwd_ref(q, k, v, o, do, **kw)

    def through_function(q, k, v, *, causal=True, window=0, softcap=0.0):
        return flash_ops._FlashAttention.apply(
            q, k, v, dict(causal=bool(causal), window=int(window),
                          softcap=float(softcap)))

    monkeypatch.setattr(fkb, "plan", lambda *a, **kw: "hopper")
    monkeypatch.setattr(fk, "flash_attention_cuda", forward)
    monkeypatch.setattr(fkb, "flash_attention_bwd_cuda", backward)
    monkeypatch.setattr(flash_ops, "flash_attention", through_function)
    _, _, tm, tp = pair("mistral-nemo-12b")
    batch = to_torch(batch_np(tm.cfg, 2, 20, seed=8))

    class NoRemat(type(tm)):
        def _run_layers(self, *a, remat=False):
            return super()._run_layers(*a, remat=False)

    loss0, _, grads0 = value_and_grad(NoRemat(tm.cfg), tp, batch)
    calls.clear()
    tm.remat_policy = policy
    try:
        loss, _, grads = value_and_grad(tm, tp, batch)
    finally:
        tm.remat_policy = None
    assert calls == [("hopper", True)] * tm.cfg.n_layers
    assert torch.equal(loss, loss0)
    for (path, g), g0 in zip(T.flatten(grads), T.leaves(grads0)):
        assert torch.equal(g, g0), path


def test_remat_policy_must_be_known():
    _, _, tm, tp = pair("minicpm-2b")
    tm.remat_policy = "everything"
    try:
        with pytest.raises(ValueError, match="remat_policy"):
            value_and_grad(tm, tp, to_torch(batch_np(tm.cfg, 1, 8)))
    finally:
        tm.remat_policy = None


def test_stacked_norm_scales_get_their_gradients_and_decay():
    """The (L, d) norm scales stay one stacked leaf whose gradient holds
    every layer's, and AdamW decays them (ndim 2) but not the final norm
    (ndim 1), as the reference does."""
    jm, jp, tm, tp = pair("minicpm-2b")
    _, _, grads = value_and_grad(tm, tp, to_torch(batch_np(tm.cfg, 2, 12)))
    g = grads["layers"]["ln1"]["scale"]
    assert g.shape == (tm.cfg.n_layers, tm.cfg.d_model)
    assert all(g[l].abs().sum() > 0 for l in range(tm.cfg.n_layers))
    opt = AdamW(lambda s: torch.tensor(1.0), AdamWConfig(weight_decay=0.5))
    params = T.map_tree(torch.clone, tp)
    zero = T.map_tree(torch.zeros_like, params)
    params, _, _ = opt.update(zero, opt.init(params), params)
    assert torch.allclose(params["layers"]["ln1"]["scale"],
                          torch.full_like(g, 0.5))
    assert torch.equal(params["final_norm"]["scale"],
                       tp["final_norm"]["scale"])
