"""The PyTorch port's single-device MoE against the JAX package: routing
(both routers, the aux loss, top-k ties), the capacity, ``apply_moe`` with
and without drops, and a MoE ``DecoderLM`` (mixtral-8x7b's smoke config
with its sliding window set to 0, the same in both packages).  Inputs come
from numpy seeds and weights from the reference's initialisers through the
bridge.  f32 at the reference kernel tests' 2e-5; bf16 at 5e-2."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import moe as jM  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ARCH = "mixtral-8x7b"


def close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **tol)


def bridged(tree):
    return params_from_flat({k: np.asarray(v) for k, v in _flatten(tree)})


def cfgs(arch=ARCH, dtype="float32", **moe):
    """The same smoke config in both packages; ``moe`` overrides fields
    of its MoEConfig."""
    out = []
    for get in (get_smoke, torch_smoke):
        cfg = get(arch).replace(dtype=dtype)
        out.append(cfg.replace(moe=dataclasses.replace(cfg.moe, **moe)))
    return out


def moe_pair(cfg, dtype="float32", seed=0):
    jp = jM.init_moe(jax.random.PRNGKey(seed), cfg, JDT[dtype])
    return jp, bridged(jp)


def activations(b, s, d, dtype="float32", seed=1):
    x = np.random.default_rng(seed).standard_normal((b, s, d))
    x = x.astype(np.float32)
    return (jnp.asarray(x).astype(JDT[dtype]),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("mode", ["softmax_topk", "sigmoid"])
def test_route_matches_reference(mode):
    jcfg, tcfg = cfgs()
    jp, tp = moe_pair(jcfg)
    jx, tx = activations(1, 40, jcfg.d_model)
    jx, tx = jx[0], tx[0]
    jidx, jg, jaux = jM.route(jx, jp["router"], jcfg.moe, mode)
    tidx, tg, taux = tM.route(tx, tp["router"], tcfg.moe, mode)
    assert tidx.dtype == torch.int64 and tg.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    close(jg, tg, TOL["float32"])
    close(jaux, taux, TOL["float32"])


@pytest.mark.parametrize("mode", ["softmax_topk", "sigmoid"])
def test_route_ties_go_to_the_lower_index(mode):
    """Router columns 1, 2 and 3 equal: every token's logits tie on them,
    and ``jax.lax.top_k`` takes the lower index first."""
    jcfg, tcfg = cfgs()
    E, d = jcfg.moe.n_experts, jcfg.d_model
    rng = np.random.default_rng(3)
    w = rng.standard_normal((d, E)).astype(np.float32)
    w[:, 2] = w[:, 3] = w[:, 1]
    w[:, 0] = -np.abs(w[:, 1]) - 1.0
    x = np.abs(rng.standard_normal((16, d))).astype(np.float32)
    jidx, jg, _ = jM.route(jnp.asarray(x), jnp.asarray(w), jcfg.moe, mode)
    tidx, tg, _ = tM.route(torch.from_numpy(x), torch.from_numpy(w),
                           tcfg.moe, mode)
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    np.testing.assert_array_equal(tidx.numpy(), np.tile([1, 2], (16, 1)))
    close(jg, tg, TOL["float32"])


def test_top_k_is_stable_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = tM.top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]


@pytest.mark.parametrize("n_tokens", [1, 7, 40, 4096])
@pytest.mark.parametrize("factor", [1.0, 1.25, 16.0])
def test_capacity_matches_reference(n_tokens, factor):
    for arch in (ARCH, "jamba-1.5-large-398b"):
        jcfg, tcfg = cfgs(arch, capacity_factor=factor)
        assert tM._capacity(n_tokens, tcfg.moe) == \
            jM._capacity(n_tokens, jcfg.moe)
    # Jamba's published MoE at a 4 x 1024 prefill wave
    assert tM._capacity(4 * 1024,
                        get_config("jamba-1.5-large-398b").moe) == 640


@pytest.mark.parametrize("mode", ["softmax_topk", "sigmoid"])
@pytest.mark.parametrize("factor", [1.0, 16.0], ids=["drops", "no-drops"])
def test_apply_moe_matches_reference(factor, mode):
    """At capacity factor 1 (smoke: 4 experts, top-2, 48 tokens, capacity
    24) experts overflow and drop assignments in token-major order, the
    same ones in both packages; at 16 none drop."""
    jcfg, tcfg = cfgs(capacity_factor=factor)
    jp, tp = moe_pair(jcfg, seed=4)
    jx, tx = activations(2, 24, jcfg.d_model, seed=5)
    jy, jaux = jM.apply_moe(jx, jp, jcfg, router_mode=mode)
    ty, taux = tM.apply_moe(tx, tp, tcfg, router_mode=mode)
    assert ty.shape == (2, 24, jcfg.d_model) and ty.dtype == torch.float32
    close(jy, ty, TOL["float32"])
    close(jaux, taux, TOL["float32"])
    idx, _, _ = tM.route(tx.reshape(48, -1), tp["router"], tcfg.moe, mode)
    load = np.bincount(idx.reshape(-1).numpy(), minlength=4)
    C = tM._capacity(48, tcfg.moe)
    assert (load.max() > C) == (factor == 1.0), (load, C)


def test_apply_moe_bf16_and_shared_experts():
    """bf16 at 5e-2, with a shared expert (the path DeepSeek-V3 takes)."""
    jcfg, tcfg = cfgs(dtype="bfloat16", n_shared_experts=1)
    jp, tp = moe_pair(jcfg, "bfloat16", seed=6)
    assert "shared" in tp and tp["gate"].dtype == torch.bfloat16
    jx, tx = activations(2, 10, jcfg.d_model, "bfloat16", seed=7)
    jy, _ = jM.apply_moe(jx, jp, jcfg)
    ty, _ = tM.apply_moe(tx, tp, tcfg)
    assert ty.dtype == torch.bfloat16
    close(jy, ty, TOL["bfloat16"])


@pytest.mark.parametrize("factor", [1.0, 16.0], ids=["drops", "no_drops"])
def test_apply_moe_bf16_rounds_only_the_hidden(factor):
    """The expert products give f32 outputs of bf16 operands and only the
    hidden ``h`` is rounded to bf16, as in the reference: at least 99% of
    the outputs are bit-identical to the reference's (the rest differ where
    an f32 sum lands on a bf16 rounding boundary).  Rounding gate, up or
    the expert outputs to bf16 as well fails this."""
    jcfg, tcfg = cfgs(dtype="bfloat16", capacity_factor=factor)
    jp, tp = moe_pair(jcfg, "bfloat16", seed=8)
    jx, tx = activations(4, 12, jcfg.d_model, "bfloat16", seed=9)
    jy, _ = jM.apply_moe(jx, jp, jcfg)
    ty, _ = tM.apply_moe(tx, tp, tcfg)
    jy = np.asarray(jy, np.float32)
    assert np.mean(jy == ty.float().numpy()) >= 0.99
    close(jy, ty, TOL["bfloat16"])


def test_mesh_modes_raise_naming_the_mesh_item():
    """The mesh modes (ported: tests/test_torch_mesh.py runs them on
    meshes) raise without the mesh context their collectives need, and
    name it; ``e_offset`` 0 and ``combine_dtype`` without a combine axis
    need no collective and give the one-device result."""
    _, tcfg = cfgs()
    _, tp = moe_pair(cfgs()[0])
    _, tx = activations(1, 4, tcfg.d_model)
    for kw in ({"ep_axis": "model"}, {"tp_axis": "model"},
               {"combine_axes": ("data",)}):
        with pytest.raises(ValueError, match="MeshContext"):
            tM.apply_moe(tx, tp, tcfg, **kw)
    y, aux = tM.apply_moe(tx, tp, tcfg, ep_axis=None, tp_axis=None)
    for kw in ({"e_offset": 0}, {"combine_dtype": torch.bfloat16}):
        y2, aux2 = tM.apply_moe(tx, tp, tcfg, **kw)
        assert torch.equal(y, y2) and torch.equal(aux, aux2)
    with pytest.raises(TypeError):
        tM.apply_moe(tx, tp, tcfg, ep_axsi="model")


def test_init_shapes_and_dtypes_match_reference():
    for shared in (0, 1):
        jcfg, tcfg = cfgs(n_shared_experts=shared)
        jflat = dict(_flatten(jax.eval_shape(
            lambda k: jM.init_moe(k, jcfg, jnp.bfloat16),
            jax.random.PRNGKey(0))))
        tp = tM.init_moe(torch.Generator().manual_seed(0), tcfg,
                         torch.bfloat16, "cpu")
        tflat = dict(_flatten_torch(tp))
        assert sorted(jflat) == sorted(tflat)
        for key, leaf in jflat.items():
            assert tuple(leaf.shape) == tuple(tflat[key].shape), key
            assert str(leaf.dtype) == str(tflat[key].dtype)[6:], key


def _flatten_torch(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten_torch(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# --------------------------------------------------------- DecoderLM + MoE


def lm_pair(dtype="float32"):
    """mixtral-8x7b's smoke config without its sliding window (the
    static-window path is not ported yet), in both packages."""
    jm = jax_build(get_smoke(ARCH).replace(dtype=dtype, sliding_window=0))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(torch_smoke(ARCH).replace(dtype=dtype,
                                               sliding_window=0))
    return jm, jp, tm, bridged(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decoder_prefill_decode_match_reference(dtype):
    jm, jp, tm, tp = lm_pair(dtype)
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jcache, jlen = jax.jit(lambda p, t: jm.prefill(p, t, 28))(
        jp, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 28)
    close(jl, tl, TOL[dtype])
    close(jcache["k"], tcache["k"], TOL[dtype])
    step = jax.jit(jm.decode)
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for _ in range(3):
        jl, jcache, jlen = step(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
        assert tlen == int(jlen)
        close(jl, tl, TOL[dtype])
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    close(jcache["v"], tcache["v"], TOL[dtype])


def test_moe_decoder_init_matches_reference_layout():
    jm, _, tm, _ = lm_pair()
    jflat = dict(_flatten(jax.eval_shape(jm.init, jax.random.PRNGKey(0))))
    tflat = dict(_flatten_torch(tm.init(torch.Generator().manual_seed(0),
                                        "cpu")))
    assert sorted(jflat) == sorted(tflat)
    for key, leaf in jflat.items():
        assert tuple(leaf.shape) == tuple(tflat[key].shape), key
    assert tm.router_mode == jm.router_mode == "softmax_topk"
