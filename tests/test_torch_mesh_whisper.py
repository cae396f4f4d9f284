"""The port's ``WhisperLM`` on a ("data", "model") mesh against the JAX
package, on the CPU: four gloo ranks (``tests/torch_mesh_ranks.py``, one
thread each, never importing JAX) on a (2, 2) mesh, every rank cutting
its blocks of the reference's weights by the rule table.  Whisper sets
no ``shard_heads``, so every `model` rank runs the attentions on all the
heads of its rows; the MLP is split over `model`, and the tied table by
vocab where `model` divides it.

Config: whisper-tiny's smoke (2 + 2 layers, d_model 64, 4 heads of 16,
d_ff 128: 64 columns a `model` rank), f32, at vocab 512 (split over
`model`) and at vocab 515 (whole, as whisper-tiny's 51865 is).  Inputs
(seed 1): 4 rows (2 a `data` rank) of 16 frames (N(0, 1)), 12 prompt
tokens and 3 forced decode steps over a self cache of 24 slots (12 a
`model` rank); 16 tokens a row for the losses.

Held:

* ``prefill`` and 3 teacher-forced ``decode`` steps: each logits row and
  the caches ``k``, ``v``, ``ck``, ``cv``, gathered whole
  (``sharding.unshard`` by ``cache_specs``), against the reference's
  model at one device;
* ``loss`` and every gradient leaf (summed over `data`, gathered whole)
  against ``jax.value_and_grad`` at one device;
* one ``make_train_step`` step with 2 microbatches and ``grad_specs``:
  loss, ``grad_norm``, the updated params and both moments against JAX's
  ``make_train_step`` at one device;
* two faults, each shown to fail the serving limit: the MLP's psum over
  `model` left out on rank (0, 1); the self cache's slot block written
  and read at offset 0 on every `model` rank;
* ``param_specs`` (the smoke config at both vocabs and whisper-tiny as
  published) and ``cache_specs`` against the reference's, and
  ``build_model`` on an active mesh.

Limits, as the other mesh tests hold the decoders
(``tests/test_torch_mesh_ssm.py``): logits and caches at rtol = atol =
2e-5; the loss and ``grad_norm`` within 2e-5 relative; each gradient
leaf, first moment and updated param within 1e-4 of the leaf's largest
|entry|, each second moment within 2e-4.  A fault must take some rank's
logits rows past 100 times the serving limit.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, get_smoke  # noqa: E402
from repro.distribution import context as jctx  # noqa: E402
from repro.distribution import sharding as jS  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.distribution import context as tctx  # noqa: E402
from repro_torch.distribution import sharding as tS  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.models.whisper import WhisperLM  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from test_torch_mesh_ssm import served, serve_errs  # noqa: E402
from test_torch_mesh_train import (  # noqa: E402
    LEAF_REL, LOSS_RTOL, V_REL, flat_np, leaf_ratios, one_device_loss,
    one_device_step, same_on_every_rank)

MESH = (2, 2)
DEADLINE_S = 240
FAULT_FACTOR = 100
PROMPT, STEPS, MAX_LEN = 12, 3, 24
FRAMES = 16
B, SEQ = 4, 16
PEAK_LR = 1e-5
ARCH = "whisper-tiny"
VOCABS = {"v512": 512, "v515": 515}
# fault name -> torch_mesh_ranks' fault (every one on vocab 512)
FAULTS = {"no-mlp-psum": ("keep-own-row-sum", get_smoke(ARCH).d_model),
          "slot-offset-0": "slot-offset-0"}


def jax_cfg(name):
    return get_smoke(ARCH).replace(dtype="float32",
                                   vocab_size=VOCABS[name])


@functools.lru_cache(maxsize=None)
def jax_model(name):
    jm = jax_build(jax_cfg(name))
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0))


def base_case(kind, name, **extra):
    _, jp = jax_model(name)
    return {"kind": kind, "arch": ARCH, "dtype": "float32",
            "replace": {"vocab_size": VOCABS[name]}, "moe": {}, "knobs": {},
            "params": params_from_flat(flat_np(jp)), **extra}


def serve_inputs(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    frames = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(
        np.float32)
    return toks, forced, frames


def one_device_serve(name):
    """The reference's logits (b, 1 + STEPS, V) and its caches."""
    jm, jp = jax_model(name)
    toks, forced, frames = serve_inputs(jm.cfg)
    logits, cache, length = jax.jit(
        lambda p, t, f: jm.prefill(p, t, MAX_LEN, frames=f))(
            jp, jnp.asarray(toks), jnp.asarray(frames))
    out = [np.asarray(logits, np.float32)]
    step = jax.jit(jm.decode)
    for i in range(STEPS):
        logits, cache, length = step(jp, cache,
                                     jnp.asarray(forced[:, i:i + 1]), length)
        out.append(np.asarray(logits, np.float32))
    return {"logits": np.concatenate(out, axis=1),
            **{f"state/{k}": v for k, v in flat_np(cache).items()}}


def serve_case(name, **extra):
    toks, forced, frames = serve_inputs(jax_cfg(name))
    return base_case("whisper_serve", name,
                     tokens=torch.from_numpy(toks).long(),
                     forced=torch.from_numpy(forced).long(),
                     frames=torch.from_numpy(frames), max_len=MAX_LEN,
                     **extra)


def batch_np(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, SEQ + 1)).astype(np.int32)
    frames = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(
        np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames}


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(every rank's outputs on the (2, 2) mesh, the one-device
    references).  The spawn starts first and runs while this process
    computes the references."""
    tmp = tmp_path_factory.mktemp("mesh_whisper")
    cases, todo = {}, []
    for name in VOCABS:
        cases[f"serve-{name}"] = serve_case(name)
        todo.append((f"serve-{name}", one_device_serve, (name,)))
        batch = batch_np(jax_cfg(name))
        jm, jp = jax_model(name)
        cases[f"loss-{name}"] = base_case("train_loss", name,
                                          batch=torch_batch(batch))
        todo.append((f"loss-{name}", one_device_loss, (jm, jp, batch)))
        cases[f"step-{name}"] = base_case(
            "train_step", name, batch=torch_batch(batch), microbatches=2,
            grad_specs=True, peak_lr=PEAK_LR)
        todo.append((f"step-{name}", one_device_step, (jm, jp, batch, 2)))
    for fault, spec in FAULTS.items():
        cases[f"fault-{fault}"] = serve_case("v512", fault=spec)
    with ThreadPoolExecutor(1) as pool:
        outs = pool.submit(ranks.spawn, cases, MESH, tmp / "ranks",
                           deadline=DEADLINE_S)
        refs = {name: fn(*args) for name, fn, args in todo}
        outs = outs.result()
    return outs, refs


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("name", list(VOCABS))
def test_prefill_decode_and_caches_match_one_device(run, name):
    outs, refs = run
    errs = serve_errs(served(outs, f"serve-{name}"), refs[f"serve-{name}"])
    assert set(errs) == {"logits", "state/k", "state/v", "state/ck",
                         "state/cv"}
    assert max(errs.values()) <= 1.0, errs


@pytest.mark.parametrize("name", list(VOCABS))
def test_loss_and_every_gradient_leaf_match_one_device(run, name):
    outs, refs = run
    got, want = same_on_every_rank(outs, f"loss-{name}"), refs[f"loss-{name}"]
    np.testing.assert_allclose(got["loss"].item(), want["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["xent"].item(), want["xent"],
                               rtol=LOSS_RTOL)
    ratios = leaf_ratios(got, want, "g/", LEAF_REL)
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("name", list(VOCABS))
def test_train_step_with_microbatches_and_grad_specs_matches_one_device(
        run, name):
    outs, refs = run
    got, want = same_on_every_rank(outs, f"step-{name}"), refs[f"step-{name}"]
    np.testing.assert_allclose(got["loss"].item(), want["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"].item(), want["grad_norm"],
                               rtol=LOSS_RTOL)
    assert got["bytes/psum_scatter"] > 0      # grad_specs' reduce-scatters
    for prefix, rel in (("p/", LEAF_REL), ("m/", LEAF_REL), ("v/", V_REL)):
        ratios = leaf_ratios(got, want, prefix, rel)
        assert max(ratios.values()) <= 1.0, (prefix, ratios)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_fails_the_limit(run, fault):
    """Each fault takes some rank's logits rows far past their limit."""
    outs, refs = run
    want = refs["serve-v512"]["logits"]
    n = want.shape[0] // MESH[0]
    worst = max(serve_errs({"logits": o[f"fault-{fault}"]["logits"]},
                           {"logits": want[c[0] * n:(c[0] + 1) * n]}
                           )["logits"] for c, o in outs.items())
    assert worst > FAULT_FACTOR, worst


def _contexts(shape):
    names = ("data", "model")
    jd = jctx.make_context(SimpleNamespace(shape=dict(zip(names, shape)),
                                           axis_names=names))
    td = tctx.make_context(SimpleNamespace(shape=tuple(shape),
                                           mesh_dim_names=names))
    return jd, td


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v)
    return out


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("config", ["smoke-v512", "smoke-v515", "published"])
def test_param_and_cache_specs_match_reference(config, shape):
    """The rule table's specs for every leaf, and the cache specs, are the
    reference's; at vocab 515 and 51865 the table stays whole over
    `model`, at 512 it is cut by vocab."""
    if config == "published":
        jcfg, tcfg = get_config(ARCH), port_config(ARCH)
    else:
        vocab = int(config.split("-v")[1])
        jcfg = get_smoke(ARCH).replace(vocab_size=vocab)
        tcfg = port_smoke(ARCH).replace(vocab_size=vocab)
    jd, td = _contexts(shape)
    jm, tm = jax_build(jcfg, jd), build_model(tcfg, td)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = _flat(jS.param_specs(jm, shapes))
    got = _flat(tS.param_specs(tm, tm.init(None, "meta")))
    assert got == want
    split = jcfg.vocab_size % shape[1] == 0
    assert want["embed/tokens"][0] == ("model" if split else None)
    assert tm.cache_specs() == {k: tuple(v)
                                for k, v in jm.cache_specs().items()}


def test_build_model_on_an_active_mesh():
    _, td = _contexts(MESH)
    wh = build_model(port_smoke(ARCH), td)
    assert type(wh) is WhisperLM and wh.dist is td
    specs, shapes = wh.layout()
    assert specs["dec"]["mlp"]["up"] == (None, "data", "model")
    assert tuple(shapes["dec"]["mlp"]["up"].shape) == (2, 64, 128)
