"""Parity of the PyTorch port's layers/common functions with their JAX
twins in ``repro.models``: the same numpy inputs through both, f32 at the
kernel tests' 2e-5 tolerance, bf16 at 5e-2; plus the weight bridge."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.distribution.context import NULL_CTX  # noqa: E402
from repro.models import common as jC  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import to_tensor  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.models import common as tC  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def arr(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def both(a, dtype="float32"):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a).to(TDT[dtype]))


def close(j, t, dtype="float32"):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(norm, dtype):
    x = arr(0, (2, 5, 48), 3.0) + 0.5
    scale = arr(1, (48,))
    (jx, tx), (js, ts) = both(x, dtype), both(scale, dtype)
    cfg = get_smoke("mistral-nemo-12b").replace(norm=norm, d_model=48)
    j = jL.apply_norm(jx, {"scale": js}, cfg)
    t = tL.apply_norm(tx, {"scale": ts}, cfg)
    assert t.dtype == TDT[dtype]
    close(j, t, dtype)
    fn = getattr(tL, norm)
    close(getattr(jL, norm)(jx, {"scale": js}, 1e-6),
          fn(tx, {"scale": ts}, 1e-6), dtype)


def test_head_rmsnorm():
    x = arr(2, (2, 7, 4, 16), 2.0)
    jx, tx = both(x)
    close(jL.head_rmsnorm(jx), tL.head_rmsnorm(tx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_rounds_like_the_reference(dtype):
    """bf16: every element equals ``jax.nn.silu``'s, which rounds each of
    its ops (exp, 1 +, 1 /, x *) to bf16; f32 at 2e-5."""
    jx, tx = both(arr(7, (40_000,), 3.0), dtype)
    j, t = jax.nn.silu(jx), tL.silu(tx)
    assert t.dtype == TDT[dtype]
    if dtype == "bfloat16":
        np.testing.assert_array_equal(np.asarray(j, np.float32),
                                      t.float().numpy())
    close(j, t, dtype)


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
def test_apply_mlp(act):
    d, ff = 24, 40
    x = arr(3, (2, 5, d))
    p = {"up": arr(4, (d, ff), 0.2), "down": arr(5, (ff, d), 0.2)}
    if act != "gelu":
        p["gate"] = arr(6, (d, ff), 0.2)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    close(jL.apply_mlp(jnp.asarray(x), jp, act),
          tL.apply_mlp(torch.from_numpy(x), tp, act))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("decode", [False, True])
def test_apply_rope(theta, decode):
    b, s, h, hd = 2, 9, 3, 16
    if decode:            # decode: positions (b, 1) at one length
        x = arr(7, (b, 1, h, hd))
        pos = np.full((b, 1), 37, np.int32)
    else:                 # prefill: positions (1, s)
        x = arr(7, (b, s, h, hd))
        pos = np.arange(s, dtype=np.int32)[None, :]
    jx, tx = both(x)
    close(jL.apply_rope(jx, jnp.asarray(pos), theta),
          tL.apply_rope(tx, torch.from_numpy(pos).long(), theta))


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma3-4b",
                                  "minicpm-2b"])
def test_embed_logits_residual(arch):
    cfg = get_smoke(arch).replace(dtype="float32")
    tcfg = torch_smoke(arch).replace(dtype="float32")
    V, d = cfg.vocab_size, cfg.d_model
    p = {"tokens": arr(8, (V, d), 0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = arr(9, (d, V), 0.1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    toks = np.random.default_rng(10).integers(0, V, (2, 6)).astype(np.int32)
    je = jC.embed(jnp.asarray(toks), jp, cfg, NULL_CTX)
    te = tC.embed(torch.from_numpy(toks), tp, tcfg)
    close(je, te)
    x = arr(11, (2, 3, d))
    close(jC.lm_logits(jnp.asarray(x), jp, cfg, NULL_CTX),
          tC.lm_logits(torch.from_numpy(x), tp, tcfg))
    assert tC.residual_scale(tcfg) == pytest.approx(
        float(jC.residual_scale(cfg)), rel=1e-7)


def test_embedding_indices_any_int_dtype():
    p = {"tokens": torch.arange(12.0).reshape(6, 2)}
    cfg = torch_smoke("mistral-nemo-12b")
    for dt in (torch.int32, torch.int64, torch.int16):
        out = tC.embed(torch.tensor([[5, 0]], dtype=dt), p, cfg)
        assert out.tolist() == [[[10.0, 11.0], [0.0, 1.0]]]


def test_bridge_bf16_bits_exact():
    a = arr(12, (3, 5, 7)).astype(ml_dtypes.bfloat16)
    t = to_tensor(a)
    assert t.dtype == torch.bfloat16 and t.shape == (3, 5, 7)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    f = to_tensor(arr(13, (4,)))
    assert f.dtype == torch.float32


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma3-4b",
                                  "minicpm-2b"])
def test_init_matches_reference_layout(arch):
    """The port's own init builds the same tree of (L, ...) stacked
    params, shapes and dtypes as the bridged reference init."""
    jmodel = jax_build(get_smoke(arch))
    ref = {k: (tuple(v.shape), str(v.dtype)) for k, v in
           _flatten(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))}
    ours = torch_build(torch_smoke(arch)).init(
        torch.Generator().manual_seed(0), "cpu")

    def layout(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(layout(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = (tuple(v.shape),
                                   str(v.dtype).removeprefix("torch."))
        return out

    assert layout(ours) == ref
