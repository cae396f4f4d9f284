"""The port's optimizer against the reference's on identical inputs:
block-wise int8 quantization bit for bit, the LR schedules in f32, and
``AdamW.update`` on the same params, gradients and moments (plain,
quantized, flat-quantized).

Tolerances: quantization and the schedules are the same f32 operations
on both sides, so bit-identical (a schedule to one f32 ulp, where XLA's
and torch's cos, exp and log may differ in the last bit); AdamW within
1e-6 relative (f32 sqrt, division and pow in another library), and
quantized moments within one quantization step of their block (a value
one ulp from a rounding boundary may round the other way).  "Relative"
is to each leaf's largest value: where b1 m and (1 - b1) g nearly cancel,
one rounding apart (an FMA on one side) is many ulps of the small
result."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import quant as jquant  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402
from repro_torch.optim import quant, schedules  # noqa: E402

SHAPES = [(), (5,), (300,), (3, 256), (2, 3, 700), (4, 1000)]


def arr(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.standard_normal(shape) * scale, np.float32)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_is_bit_identical(shape, flat):
    x = arr(shape, seed=len(shape), scale=3.0)
    jfn = jquant.quantize_flat if flat else jquant.quantize
    tfn = quant.quantize_flat if flat else quant.quantize
    jq, tq = jfn(jnp.asarray(x)), tfn(torch.from_numpy(x))
    assert tq.shape == jq.shape == shape
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(quant.dequantize(tq).numpy(),
                                  np.asarray(jquant.dequantize(jq)))


def test_quantize_rounds_half_to_even():
    """A block whose scale is 1: its halves round to even, as jnp.round."""
    x = np.zeros(256, np.float32)
    x[0] = 127.0
    x[1:5] = [0.5, 1.5, 2.5, -0.5]
    q = quant.quantize(torch.from_numpy(x)).q.numpy().reshape(-1)
    np.testing.assert_array_equal(q[:5], [127, 0, 2, 2, 0])
    np.testing.assert_array_equal(
        q, np.asarray(jquant.quantize(jnp.asarray(x)).q).reshape(-1))


SCHEDULES = [
    ("cosine", dict(peak_lr=3e-3, warmup=10, total=100)),
    ("wsd", dict(peak_lr=3e-3, warmup=10, stable=30, decay=25)),
    ("linear", dict(peak_lr=1e-3, warmup=5, total=50)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedules_match_in_f32(name, kw):
    jfn, _ = jsched.make_schedule(name)
    tfn, _ = schedules.make_schedule(name)
    for step in range(0, 120, 3):
        want = np.asarray(jfn(jnp.int32(step), **kw), np.float32)
        got = tfn(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def tree_np(seed, scales):
    """A small param-shaped tree: a stacked (L, d) norm scale, a matrix,
    a 1-d vector and a stacked 3-d weight."""
    shapes = {"ln": {"scale": (2, 40)}, "w": (40, 300), "b": (7,),
              "stack": (2, 3, 260)}
    rng = np.random.default_rng(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return (rng.standard_normal(node) * scales).astype(np.float32)
    return make(shapes)


def to_torch(tree):
    return T.map_tree(lambda a: torch.from_numpy(np.array(a)), tree)


def to_jax(tree):
    return T.map_tree(jnp.asarray, tree)


@pytest.mark.parametrize("quantized,flat", [(False, False), (True, False),
                                            (True, True)])
def test_adamw_update_matches_reference(quantized, flat):
    """Three steps on identical params, gradients and moments, the
    moments carried over from the reference's previous step: params
    within 1e-6 relative; plain moments within 1e-6; quantized ones
    within one quantization step of their block; grad_norm and lr within
    1e-6."""
    cfg = dict(weight_decay=0.1, clip_norm=0.5, quantized=quantized,
               flat_moments=flat)

    def sched(s):
        return 1e-2 * s / 3

    jopt, opt = JAdamW(sched, JAdamWConfig(**cfg)), AdamW(
        sched, AdamWConfig(**cfg))
    params = tree_np(0, 1.0)
    jstate = jopt.init(to_jax(params))
    for i in range(3):
        grads = tree_np(10 + i, 0.3)
        jp, jstate_new, jm = jopt.update(to_jax(grads), jstate,
                                         to_jax(params))
        state = _state_to_torch(jstate, quantized)
        tp, state_new, m = opt.update(to_torch(grads), state,
                                      to_torch(params))
        for path, t in T.flatten(tp):
            _close(t.numpy(), np.asarray(_at(jp, path)))
        for key in ("m", "v"):
            _moments_close(state_new[key], jstate_new[key], quantized)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(state_new["step"]) == int(jstate_new["step"]) == i + 1
        params = T.map_tree(np.asarray, jp)
        jstate = jstate_new


def test_adamw_clips_and_updates_in_place():
    opt = AdamW(lambda s: torch.tensor(1e-3), AdamWConfig(clip_norm=1.0))
    params = to_torch(tree_np(1, 1.0))
    ptr = params["w"].data_ptr()
    state = opt.init(params)
    m_ptr = state["m"]["w"].data_ptr()
    grads = to_torch(tree_np(2, 100.0))
    params, state, m = opt.update(grads, state, params)
    assert m["grad_norm"].item() > 100
    assert params["w"].data_ptr() == ptr
    assert state["m"]["w"].data_ptr() == m_ptr
    # clipped to norm 1: |m| = (1 - b1) |g| / |g|_2 summed in quadrature
    m_norm = torch.sqrt(sum((t ** 2).sum() for t in T.leaves(state["m"])))
    np.testing.assert_allclose(m_norm.item(), 0.1, rtol=1e-5)


def _close(got, want, rel=1e-6):
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


def _at(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _state_to_torch(jstate, quantized):
    def conv(x):
        if quantized and isinstance(x, jquant.QTensor):
            return quant.QTensor(torch.from_numpy(np.array(x.q)),
                                 torch.from_numpy(np.array(x.scale)),
                                 x.shape)
        return torch.from_numpy(np.array(x))
    import jax
    return {"m": jax.tree.map(conv, jstate["m"],
                              is_leaf=jquant.is_qtensor),
            "v": jax.tree.map(conv, jstate["v"],
                              is_leaf=jquant.is_qtensor),
            "step": torch.from_numpy(np.array(jstate["step"]))}


def _moments_close(got, want, quantized):
    is_q = quant.is_qtensor
    for path, g in T.flatten(got, is_leaf=is_q):
        w = _at(want, path)
        if not quantized:
            _close(g.numpy(), np.asarray(w))
            continue
        assert g.shape == w.shape and g.q.shape == w.q.shape
        np.testing.assert_allclose(g.scale.numpy(), np.asarray(w.scale),
                                   rtol=1e-6)
        step = np.abs(g.q.numpy().astype(np.int32)
                      - np.asarray(w.q).astype(np.int32))
        assert step.max() <= 1
