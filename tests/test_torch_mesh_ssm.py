"""The port's recurrent families on a ("data", "model") mesh against the
JAX package, on the CPU: ``RWKVLM`` (K2 on each rank's heads) and
``JambaLM`` (K3 on each rank's Mamba channels, K1 on its q heads, the MoE
expert-parallel), four gloo ranks (``tests/torch_mesh_ranks.py``, one
thread each, never importing JAX) on a (2, 2) mesh, every rank cutting
its blocks of the reference's weights.

Configs, f32: rwkv6-1.6b's smoke (2 layers, d_model 64, 4 heads of 16,
vocab 512 split over `model`); a one-period cut of Jamba's smoke (4
layers, attention at offset 2, MoE on the odd layers with 4 experts, 2 a
rank) and its dense twin (the same cut with no MoE layer).  Batches: 4
rows (2 a `data` rank) of 12 prompt tokens and 3 forced decode steps
(Jamba with ``sp_decode``, 24 cache slots, 12 a `model` rank), and of 16
tokens for the losses (seed 1; seed 2 for the f64 witness).

Held:

* ``prefill`` and 3 teacher-forced ``decode`` steps: each logits row and
  the state, gathered whole (``sharding.unshard`` by ``cache_specs``),
  against the reference's model at one device: RWKV, the dense Jamba cut,
  and the MoE cut at capacity factor 16 (no token dropped on either side);
* ``loss`` and every gradient leaf (summed over `data`, gathered whole)
  against ``jax.value_and_grad`` at one device: RWKV and the dense Jamba
  cut; the MoE cut against the reference's model on a (2, 2) mesh of four
  host devices with Auto axes, in a subprocess (its MoE takes capacity and
  aux on each `data` shard);
* one ``make_train_step`` step with 2 microbatches and ``grad_specs``:
  loss, ``grad_norm``, the updated params and both moments against JAX's
  ``make_train_step`` at one device (RWKV, the dense Jamba cut);
* at seed 2's batch, where RWKV's f32 gradients are ill-conditioned
  (ROADMAP, "RWKV's f32 gradients are ill-conditioned at some inputs"):
  ``loss`` and every gradient leaf of the port in f64 on the (2, 2) mesh
  against the reference in f64 at one device (both packages' float32
  taken as float64: ``torch_mesh_ranks.F64_BOOT``, the JAX subprocess
  after its mesh runs), at the limits below; the f32 runs' distances
  from the f64 gradient (the port's on the mesh, the reference's at one
  device) recorded as the test's properties;
* faults, each shown to fail the serving limit: Mamba's ``in_proj`` cut
  as one contiguous block (every rank), the psum of RWKV's ``wo`` left
  out on rank (0, 1), K2's ``u`` and ``w0`` taken at head offset 0 (every
  rank), the psum of Mamba's ``x_proj`` left out on rank (0, 1);
* ``build_model`` on an active mesh (WhisperLM's too), and the cache
  specs against the reference's.

Limits, as the existing mesh tests hold ``DecoderLM``
(``tests/test_torch_mesh.py``, ``tests/test_torch_mesh_train.py``):
logits and states at rtol = atol = 2e-5; the loss and ``grad_norm``
within 2e-5 relative; each gradient leaf, first moment and updated param
within 1e-4 of the leaf's largest |entry|, each second moment within
2e-4.
"""
from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.distribution import context as jctx  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.distribution import context as tctx  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.models.hybrid import JambaLM  # noqa: E402
from repro_torch.models.rwkv_lm import RWKVLM  # noqa: E402
from repro_torch.models.whisper import WhisperLM  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from test_torch_mesh_train import (  # noqa: E402
    LEAF_REL, LOSS_RTOL, V_REL, jax_mesh_refs, leaf_ratios, one_device_loss,
    one_device_step, same_on_every_rank)

MESH = (2, 2)
DEADLINE_S = 240
TOL = dict(rtol=2e-5, atol=2e-5)
PROMPT, STEPS, MAX_LEN = 12, 3, 24
B, SEQ = 4, 16
PEAK_LR = 1e-5
LOSS_SEED, ILL_SEED = 1, 2
RWKV = "rwkv6-1.6b"
JAMBA = "jamba-1.5-large-398b"
CUT = {"n_layers": 4}
DENSE = {"layer_offset": 2}           # j % 2 == 2 never: no MoE layer
NO_DROPS = {"capacity_factor": 16.0}

# arch, config replacements, MoE overrides, knobs
MODELS = {"rwkv": (RWKV, {}, {}, {}),
          "jamba-dense": (JAMBA, CUT, DENSE, {"sp_decode": True}),
          "jamba-moe": (JAMBA, CUT, {}, {"sp_decode": True}),
          "jamba-moe-no-drops": (JAMBA, CUT, NO_DROPS, {"sp_decode": True})}
SERVE = ("rwkv", "jamba-dense", "jamba-moe-no-drops")
LOSS_ONE_DEVICE = ("rwkv", "jamba-dense")
LOSS_ON_MESH = ("jamba-moe",)
STEP = ("rwkv", "jamba-dense")


def _fault_cases():
    cfg = get_smoke(JAMBA)
    xproj = cfg.mamba.dt_rank + 2 * cfg.mamba.d_state
    return {"in-proj-contiguous": ("jamba-dense", "in-proj-contiguous"),
            "no-wo-psum": ("rwkv", ("keep-own-row-sum",
                                    get_smoke(RWKV).d_model)),
            "u-w0-offset-0": ("rwkv", "offset-0"),
            "no-x-proj-psum": ("jamba-dense", ("keep-own-row-sum", xproj))}


FAULTS = _fault_cases()


def jax_cfg(name):
    arch, replace, moe, _ = MODELS[name]
    cfg = get_smoke(arch).replace(dtype="float32", **replace)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


@functools.lru_cache(maxsize=None)
def jax_model(name):
    jm = jax_build(jax_cfg(name))
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0))


def flat_np(tree):
    return {k: np.asarray(v, np.float32) for k, v in _flatten(tree)}


def base_case(kind, name, **extra):
    arch, replace, moe, knobs = MODELS[name]
    _, jp = jax_model(name)
    return {"kind": kind, "arch": arch, "dtype": "float32",
            "replace": replace, "moe": moe, "knobs": knobs,
            "params": params_from_flat(flat_np(jp)), **extra}


def serve_inputs(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    return toks, forced


def one_device_serve(name):
    """The reference's logits (b, 1 + STEPS, V) and final state."""
    jm, jp = jax_model(name)
    toks, forced = serve_inputs(jm.cfg)
    logits, cache, length = jax.jit(lambda p, t: jm.prefill(p, t, MAX_LEN))(
        jp, jnp.asarray(toks))
    out = [np.asarray(logits, np.float32)]
    step = jax.jit(jm.decode)
    for i in range(STEPS):
        logits, cache, length = step(jp, cache,
                                     jnp.asarray(forced[:, i:i + 1]), length)
        out.append(np.asarray(logits, np.float32))
    return {"logits": np.concatenate(out, axis=1),
            **{f"state/{k}": v for k, v in flat_np(cache).items()}}


def serve_case(name, **extra):
    toks, forced = serve_inputs(jax_cfg(name))
    return base_case("ssm_serve", name, tokens=torch.from_numpy(toks).long(),
                     forced=torch.from_numpy(forced).long(), max_len=MAX_LEN,
                     **extra)


def batch_np(cfg, seed=LOSS_SEED):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


# --------------------------------------------- the JAX package on a mesh

JAX_MESH = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.checkpointing.checkpoint import _flatten
from repro.configs import get_smoke
from repro.distribution.context import make_context
from repro.models.factory import build_model
io = dict(np.load(sys.argv[1], allow_pickle=True))
out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
for name in io["names"]:
    arch, replace, moe = io[name + "/spec"].tolist()
    cfg = get_smoke(arch).replace(dtype="float32", **replace)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
    model = build_model(cfg, make_context(mesh))
    batch = {k: jnp.asarray(io[f"{name}/batch/{k}"])
             for k in ("tokens", "labels")}
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, batch)
    out[name + "/loss"] = np.float32(loss)
    out[name + "/xent"] = np.float32(metrics["xent"])
    for k, v in _flatten(g):
        out[f"{name}/g/{k}"] = np.asarray(v, np.float32)
# the f64 witness: the f32 params, then every float32 the package names
# taken as float64, the model built after that, at one device
cfg = get_smoke(str(io["witness/arch"])).replace(dtype="float32")
p32 = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
jax.config.update("jax_enable_x64", True)
jnp.float32 = jnp.float64
p64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x), jnp.float64), p32)
batch = {k: jnp.asarray(io[f"witness/batch/{k}"])
         for k in ("tokens", "labels")}
(loss, _), g = jax.jit(jax.value_and_grad(build_model(cfg).loss,
                                          has_aux=True))(p64, batch)
out["witness/loss"] = np.asarray(loss)
for k, v in _flatten(g):
    out[f"witness/g/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def jax_mesh_inputs():
    io = {"names": np.array(list(LOSS_ON_MESH))}
    for name in LOSS_ON_MESH:
        arch, replace, moe, _ = MODELS[name]
        io[name + "/spec"] = np.array((arch, replace, moe), dtype=object)
        for k, v in batch_np(jax_cfg(name)).items():
            io[f"{name}/batch/{k}"] = v
    io["witness/arch"] = np.array(RWKV)
    for k, v in batch_np(jax_cfg("rwkv"), ILL_SEED).items():
        io[f"witness/batch/{k}"] = v
    return io


# -------------------------------------------------------------- the runs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(every rank's outputs on the (2, 2) mesh, the one-device references,
    the JAX subprocess's outputs, every rank's outputs of the f64 witness).
    The JAX subprocess and both spawns start first and run while this
    process computes the one-device references."""
    tmp = tmp_path_factory.mktemp("mesh_ssm")
    cases, todo = {}, []
    for name in SERVE:
        cases[f"serve-{name}"] = serve_case(name)
        todo.append((f"serve-{name}", one_device_serve, (name,)))
    for fault, (name, spec) in FAULTS.items():
        cases[f"fault-{fault}"] = serve_case(name, fault=spec)
    for name in LOSS_ONE_DEVICE + LOSS_ON_MESH:
        batch = batch_np(jax_cfg(name))
        cases[f"loss-{name}"] = base_case("train_loss", name,
                                          batch=torch_batch(batch))
        if name in LOSS_ONE_DEVICE:
            jm, jp = jax_model(name)
            todo.append((f"loss-{name}", one_device_loss, (jm, jp, batch)))
    ill = batch_np(jax_cfg("rwkv"), ILL_SEED)
    cases["loss-rwkv-ill"] = base_case("train_loss", "rwkv",
                                       batch=torch_batch(ill))
    jm, jp = jax_model("rwkv")
    todo.append(("loss-rwkv-ill", one_device_loss, (jm, jp, ill)))
    witness = {"witness": base_case("train_loss", "rwkv",
                                    batch=torch_batch(ill))}
    for name in STEP:
        batch = batch_np(jax_cfg(name))
        cases[f"step-{name}"] = base_case(
            "train_step", name, batch=torch_batch(batch), microbatches=2,
            grad_specs=True, peak_lr=PEAK_LR)
        jm, jp = jax_model(name)
        todo.append((f"step-{name}", one_device_step, (jm, jp, batch, 2)))
    jax_mesh = ranks.JaxRun(tmp, JAX_MESH, jax_mesh_inputs(), DEADLINE_S)
    try:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(2) as pool:
            outs = pool.submit(ranks.spawn, cases, MESH, tmp / "ranks",
                               deadline=DEADLINE_S)
            outs64 = pool.submit(ranks.spawn, witness, MESH, tmp / "ranks64",
                                 deadline=DEADLINE_S, f64=True)
            refs = {name: fn(*args) for name, fn, args in todo}
            outs, outs64 = outs.result(), outs64.result()
        jax_out = jax_mesh.outputs()
    finally:
        jax_mesh.close()
    return outs, refs, jax_out, outs64


def served(outs, name):
    """A serving case's logits rows in batch order (each `data` rank's,
    after checking that its `model` ranks hold the same bits) and its
    state (gathered whole: the same on every rank)."""
    out = {"logits": ranks.by_rows(
        {c: {name: o[name]["logits"]} for c, o in outs.items()}, name, MESH)}
    first = outs[(0, 0)][name]
    for k, v in first.items():
        if k.startswith("state/"):
            for c, o in outs.items():
                assert torch.equal(o[name][k], v), (name, c, k)
            out[k] = v
    return out


def serve_errs(got, want):
    """{key: max |got - want| / (atol + rtol |want|)} of the logits and
    every state leaf; a key passes at <= 1."""
    assert set(got) == set(want), (set(got) ^ set(want))
    out = {}
    for k, w in want.items():
        g = got[k].float().numpy()
        assert g.shape == w.shape, (k, g.shape, w.shape)
        out[k] = float((np.abs(g - w) / (TOL["atol"] + TOL["rtol"]
                                         * np.abs(w))).max())
    return out


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("name", SERVE)
def test_prefill_decode_and_state_match_one_device(run, name):
    outs, refs, _, _ = run
    errs = serve_errs(served(outs, f"serve-{name}"), refs[f"serve-{name}"])
    assert max(errs.values()) <= 1.0, errs


@pytest.mark.parametrize("name", LOSS_ONE_DEVICE)
def test_loss_and_every_gradient_leaf_match_one_device(run, name):
    outs, refs, _, _ = run
    got, want = same_on_every_rank(outs, f"loss-{name}"), refs[f"loss-{name}"]
    np.testing.assert_allclose(got["loss"].item(), want["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["xent"].item(), want["xent"],
                               rtol=LOSS_RTOL)
    ratios = leaf_ratios(got, want, "g/", LEAF_REL)
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("name", LOSS_ON_MESH)
def test_moe_loss_and_gradients_match_the_reference_on_a_mesh(run, name):
    outs, _, jax_out, _ = run
    got = same_on_every_rank(outs, f"loss-{name}")
    want = jax_mesh_refs(jax_out, name)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["xent"].item(), float(want["xent"]),
                               rtol=LOSS_RTOL)
    ratios = leaf_ratios(got, want, "g/", LEAF_REL)
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("name", STEP)
def test_train_step_with_microbatches_and_grad_specs_matches_one_device(
        run, name):
    outs, refs, _, _ = run
    got, want = same_on_every_rank(outs, f"step-{name}"), refs[f"step-{name}"]
    np.testing.assert_allclose(got["loss"].item(), want["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"].item(), want["grad_norm"],
                               rtol=LOSS_RTOL)
    assert got["bytes/psum_scatter"] > 0      # grad_specs' reduce-scatters
    for prefix, rel in (("p/", LEAF_REL), ("m/", LEAF_REL), ("v/", V_REL)):
        ratios = leaf_ratios(got, want, prefix, rel)
        assert max(ratios.values()) <= 1.0, (prefix, ratios)


def worst_leaf(got, want):
    """max over the gradient leaves of max |got - want| / (LEAF_REL x the
    leaf's largest |want|), in f64, as a Python float (pytest-xdist
    carries ``user_properties`` between processes)."""
    return float(max(np.abs(np.asarray(got[k], np.float64) - want[k]).max()
                     / (LEAF_REL * np.abs(want[k]).max())
                     for k in want if k.startswith("g/")))


def test_rwkv_gradients_at_an_ill_conditioned_batch_match_in_f64(
        run, request):
    """Seed 2's batch: the port's f32 gradient misses the reference's f32
    one by more than LEAF_REL, and both f32 runs miss the f64 gradient
    (ROADMAP).  In f64 the port on the mesh holds the reference at the
    limits; each run's distance from the f64 gradient, and the f32 port's
    from the f32 reference, in LEAF_REL units, are recorded in the test's
    ``user_properties`` (the JUnit XML's)."""
    outs, refs, jax_out, outs64 = run
    got = same_on_every_rank(outs64, "witness")
    want = jax_mesh_refs(jax_out, "witness")
    assert {str(v.dtype) for v in want.values()} == {"float64"}
    assert {v.dtype for k, v in got.items()
            if not k.startswith("bytes/")} == {torch.float64}
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=LOSS_RTOL)
    ratios = leaf_ratios(got, want, "g/", LEAF_REL)
    assert max(ratios.values()) <= 1.0, ratios
    port32 = same_on_every_rank(outs, "loss-rwkv-ill")
    request.node.user_properties += [
        ("port_f64_mesh", worst_leaf(got, want)),
        ("port_f32_mesh", worst_leaf(port32, want)),
        ("reference_f32", worst_leaf(refs["loss-rwkv-ill"], want)),
        ("port_f32_mesh_from_reference_f32",
         worst_leaf(port32, refs["loss-rwkv-ill"]))]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_fails_the_limit(run, fault):
    """Each fault takes the logits rows far past their limit, on the
    rank that holds it or on every rank."""
    outs, refs, _, _ = run
    name = FAULTS[fault][0]
    want = refs[f"serve-{name}"]["logits"]
    n = want.shape[0] // MESH[0]
    worst = max(serve_errs({"logits": o[f"fault-{fault}"]["logits"]},
                           {"logits": want[c[0] * n:(c[0] + 1) * n]}
                           )["logits"] for c, o in outs.items())
    assert worst > 100, worst


def test_build_model_on_an_active_mesh():
    """RWKVLM, JambaLM and WhisperLM build on an active mesh (Whisper's
    mesh runs: ``tests/test_torch_mesh_whisper.py``)."""
    td = tctx.make_context(SimpleNamespace(shape=(2, 2),
                                           mesh_dim_names=("data", "model")))
    rw = build_model(port_smoke(RWKV), td)
    jb = build_model(port_smoke(JAMBA), td, long_context=True)
    assert type(rw) is RWKVLM and rw.dist is td and rw.n_local_heads == 2
    assert type(jb) is JambaLM and jb.dist is td and jb.long_context
    assert jb.shard_heads and jb.moe_ep
    wh = build_model(port_smoke("whisper-tiny"), td)
    assert type(wh) is WhisperLM and wh.dist is td


@pytest.mark.parametrize("kv_seq", [None, ("data", "model")])
def test_cache_specs_match_reference(kv_seq):
    """Jamba's cache specs are the reference's; RWKV's wkv state is, and
    its shift carries stay whole over `model` (``rwkv_lm.py``'s
    docstring), where the reference cuts them."""
    names = ("data", "model")
    jd = jctx.make_context(SimpleNamespace(shape=dict(zip(names, (2, 4))),
                                           axis_names=names), kv_seq=kv_seq)
    td = tctx.make_context(SimpleNamespace(shape=(2, 4),
                                           mesh_dim_names=names),
                           kv_seq=kv_seq)
    jj = jax_build(get_smoke(JAMBA), jd).cache_specs()
    tj = JambaLM(port_smoke(JAMBA), td).cache_specs()
    for k in ("attn", "mamba"):
        for leaf in tj[k]:
            assert tj[k][leaf] == tuple(jj[k][leaf]), (k, leaf)
    jr = jax_build(get_smoke(RWKV), jd).cache_specs()
    tr = RWKVLM(port_smoke(RWKV), td).cache_specs()
    assert tr["wkv"] == tuple(jr["wkv"])
    for carry in ("tm_x", "cm_x"):
        assert tuple(jr[carry]) == (None, "data", "model")
        assert tr[carry] == (None, "data", None)
