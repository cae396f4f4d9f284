"""The port's training on a ("data", "model") mesh against the JAX package,
on the CPU: four gloo ranks (``tests/torch_mesh_ranks.py``, one thread
each, never importing JAX) on a (2, 2) mesh, every rank cutting its FSDP
and TP blocks of the reference's weights (``shard_params(...,
train=True)``), then a ("stage",) mesh of four for ``gpipe_forward``.

Held, f32, smoke configs, a global batch of 4 rows of 16 tokens (2 rows a
`data` rank):

* ``DecoderLM.loss`` and every gradient leaf (summed over `data`,
  gathered whole) against ``jax.value_and_grad`` at one device:
  mistral-nemo-12b (GQA, a ``loss_mask``), minicpm-2b (tied head) at its
  smoke vocab 512 (split over `model`) and at 511 (whole, as the
  published 122753 is), a ``loss_mask`` whose rows keep far more tokens
  on one `data` rank than on the other (the global mean, not a mean of
  the ranks' means), gemma3-4b (qk norm, local and global layers) and
  deepseek-v3-671b (MLA, MoE, MTP) with capacity factor 16 and no aux
  loss;
* the MoE configs against ``jax.value_and_grad`` of the reference's model
  on a (2, 2) mesh of four host devices with Auto axes, in a subprocess
  (its MoE shard_map computes capacity and aux on each `data` shard):
  mixtral-8x7b with its experts over `model` (EP) and with each expert's
  hidden dim over `model` (TP), at the published capacity factor, and
  deepseek-v3-671b;
* one ``make_train_step`` step (AdamW, cosine, clip) with microbatches 1
  and 2, with and without ``grad_specs``: loss, ``grad_norm``, the
  updated params and both moments against JAX's ``make_train_step`` at
  one device, and the collectives' bytes showing the two reductions;
* two faults that each break one of ``collectives.py``'s conventions on
  every rank: ``enter`` left out (a replicated value's gradient left
  partial over `model`), the `data` sum of the leaves no `data` dim cuts
  left out;
* ``gpipe_forward`` against the JAX package's on a 4-device ("stage",)
  mesh, as ``tests/test_distributed.py:115-140`` sets it up, and
  ``pipeline_bubble_fraction``;
* ``compress_with_feedback`` bit for bit on each rank's gradient and
  ``compressed_psum`` over `data` against the JAX package's on a
  2-device mesh.

Limits: the loss and ``grad_norm`` within 2e-5 relative; each gradient
leaf, each first moment and each updated param within 1e-4 of the leaf's
largest |entry|; each second moment within 2e-4 of its largest (it is
the gradient squared: twice the gradient's relative error).  The step
runs at a peak learning rate of 1e-5: Adam's first update is about
sign(g), so an entry whose gradient is near zero may take the other sign
on the two sides, which at 1e-5 moves it by at most 2e-5, inside the
params' limit (the gradients and moments are held on their own).
"""
from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import cosine as jcosine  # noqa: E402
from repro.optim import quant as jquant  # noqa: E402
from repro.training.step import make_train_step as jax_train_step  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.training.pipeline import \
    pipeline_bubble_fraction  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402

MESH = (2, 2)
DEADLINE_S = 240
LOSS_RTOL = 2e-5
LEAF_REL = 1e-4
V_REL = 2e-4
B, SEQ = 4, 16
PEAK_LR = 1e-5
NO_DROPS = {"capacity_factor": 16.0}

# loss cases held to the JAX package at one device: arch, config
# replacements, MoE overrides, knobs, loss mask ("random": 70% kept;
# "skewed": 90% on data rank 0's rows, 10% on rank 1's)
ONE_DEVICE = {
    "mistral": ("mistral-nemo-12b", {}, {}, {}, "random"),
    "minicpm": ("minicpm-2b", {}, {}, {}, None),
    "minicpm-vocab511": ("minicpm-2b", {"vocab_size": 511}, {}, {}, None),
    "mask-skewed": ("mistral-nemo-12b", {}, {}, {}, "skewed"),
    # qk norm: its q scale enters the local heads' computation
    "gemma": ("gemma3-4b", {}, {}, {}, "random"),
    "deepseek-no-aux": ("deepseek-v3-671b", {},
                        {**NO_DROPS, "aux_loss_coef": 0.0}, {}, None),
}
# held to the JAX package's model on a (2, 2) mesh
ON_MESH = {
    "mixtral-ep": ("mixtral-8x7b", {}, {}, {}, None),
    "mixtral-tp": ("mixtral-8x7b", {}, {}, {"moe_ep": False}, None),
    "deepseek-mesh": ("deepseek-v3-671b", {}, NO_DROPS, {}, None),
}
FAULTS = {f"fault-{f}": f for f in ranks.FAULTS}
# train-step cases: arch, MoE overrides, microbatches, grad_specs
STEP_ARCH = "mistral-nemo-12b"
STEPS = {"step-mb1": (STEP_ARCH, {}, 1, False),
         "step-mb1-specs": (STEP_ARCH, {}, 1, True),
         "step-mb2": (STEP_ARCH, {}, 2, False),
         "step-mb2-specs": (STEP_ARCH, {}, 2, True),
         "step-mb2-specs-minicpm": ("minicpm-2b", {}, 2, True),
         "step-mb2-specs-deepseek": ("deepseek-v3-671b",
                                     {**NO_DROPS, "aux_loss_coef": 0.0}, 2,
                                     True)}
GPIPE = dict(S=4, M=6, mb=2, d=16)
COMPRESS_SHAPES = [(3, 300), (4, 512)]


def jax_cfg(arch, replace, moe):
    cfg = get_smoke(arch).replace(dtype="float32", **replace)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def batch_np(cfg, mask):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, SEQ + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask == "random":
        out["loss_mask"] = (rng.random((B, SEQ)) < 0.7).astype(np.float32)
    elif mask == "skewed":
        keep = np.array([0.9, 0.9, 0.1, 0.1])[:, None]
        out["loss_mask"] = (rng.random((B, SEQ)) < keep).astype(np.float32)
        out["loss_mask"][2, 0] = 1.0     # at least one token on rank 1
    return out


@functools.lru_cache(maxsize=None)
def jax_model(arch, replace, moe):
    cfg = jax_cfg(arch, dict(replace), dict(moe))
    jm = jax_build(cfg)
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0))


def flat_np(tree):
    return {k: np.asarray(v, np.float32) for k, v in _flatten(tree)}


def rank_case(kind, arch, replace, moe, knobs, mask, **extra):
    jm, jp = jax_model(arch, tuple(replace.items()), tuple(moe.items()))
    batch = batch_np(jm.cfg, mask)
    case = {"kind": kind, "arch": arch, "dtype": "float32",
            "replace": replace, "moe": moe, "knobs": knobs,
            "params": params_from_flat(flat_np(jp)),
            "batch": {k: torch.from_numpy(v).long() if v.dtype == np.int32
                      else torch.from_numpy(v) for k, v in batch.items()},
            **extra}
    return case, jm, jp, batch


def one_device_loss(jm, jp, batch):
    (loss, metrics), g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(loss), "xent": float(metrics["xent"]),
            **{f"g/{k}": v for k, v in flat_np(g).items()}}


@functools.lru_cache(maxsize=None)
def _jax_step(jm, microbatches):
    opt = JAdamW(lambda s: jcosine(s, peak_lr=PEAK_LR, warmup=2, total=10),
                 JAdamWConfig())
    return opt, jax.jit(jax_train_step(jm, opt, microbatches=microbatches))


def one_device_step(jm, jp, batch, microbatches):
    opt, step = _jax_step(jm, microbatches)
    p, state, m = step(jp, opt.init(jp),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    for key, tree in (("p", p), ("m", state["m"]), ("v", state["v"])):
        out.update({f"{key}/{k}": v for k, v in flat_np(tree).items()})
    return out


# --------------------------------------------- the JAX package on a mesh

JAX_MESH = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.checkpointing.checkpoint import _flatten
from repro.compat import shard_map
from repro.configs import get_smoke
from repro.distribution.context import make_context
from repro.models.factory import build_model
from repro.optim.quant import compressed_psum
from repro.training.pipeline import gpipe_forward
io = dict(np.load(sys.argv[1], allow_pickle=True))
out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
for name in io["mesh_names"]:
    arch, replace, moe, knobs = io[name + "/spec"].tolist()
    cfg = get_smoke(arch).replace(dtype="float32", **replace)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
    model = build_model(cfg, make_context(mesh))
    for k, v in knobs.items():
        setattr(model, k, v)
    batch = {k: jnp.asarray(io[f"{name}/batch/{k}"])
             for k in ("tokens", "labels")}
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, batch)
    out[name + "/loss"] = np.float32(loss)
    out[name + "/xent"] = np.float32(metrics["xent"])
    for k, v in _flatten(g):
        out[f"{name}/g/{k}"] = np.asarray(v, np.float32)
stage = jax.make_mesh((4,), ("stage",), axis_types=(AxisType.Auto,))
params = {"w": jnp.asarray(io["gpipe/w"]), "b": jnp.asarray(io["gpipe/b"])}
out["gpipe"] = np.asarray(jax.jit(lambda p, x: gpipe_forward(
    lambda q, y: jnp.tanh(y @ q["w"] + q["b"]), p, x, mesh=stage,
    axis="stage"))(params, jnp.asarray(io["gpipe/xs"])))
pair = jax.make_mesh((2,), ("data",), axis_types=(AxisType.Auto,),
                     devices=jax.devices()[:2])
for i in range(int(io["n_compress"])):
    def f(g, e):
        s, ne = compressed_psum(g[0], e[0], "data")
        return s[None], ne[None]
    s, ne = jax.jit(shard_map(f, mesh=pair, in_specs=(P("data"), P("data")),
                              out_specs=(P("data"), P("data")),
                              check_vma=False))(
        jnp.asarray(io[f"compress{i}/grads"]),
        jnp.asarray(io[f"compress{i}/errors"]))
    out[f"compress{i}/sum"] = np.asarray(s)
    out[f"compress{i}/err"] = np.asarray(ne)
np.savez(sys.argv[2], **out)
"""


def jax_mesh_inputs(cases, gpipe, compress):
    """``JAX_MESH``'s inputs: each ``ON_MESH`` case's spec and batch, the
    pipeline's and the compression's."""
    io = {"mesh_names": np.array(list(ON_MESH)),
          "n_compress": len(compress)}
    for name, (arch, replace, moe, knobs, _) in ON_MESH.items():
        io[name + "/spec"] = np.array((arch, replace, moe, knobs),
                                      dtype=object)
        for k in ("tokens", "labels"):
            io[f"{name}/batch/{k}"] = cases[name]["batch"][k].numpy()
    io.update({f"gpipe/{k}": v for k, v in gpipe.items()})
    for i, (g, e) in enumerate(compress):
        io[f"compress{i}/grads"], io[f"compress{i}/errors"] = g, e
    return io


def gpipe_inputs():
    g = GPIPE
    rng = np.random.default_rng(7)
    return {"w": (rng.standard_normal((g["S"], g["d"], g["d"])) * 0.3
                  ).astype(np.float32),
            "b": (rng.standard_normal((g["S"], g["d"])) * 0.1
                  ).astype(np.float32),
            "xs": rng.standard_normal((g["M"], g["mb"], g["d"])
                                      ).astype(np.float32)}


def compress_inputs():
    rng = np.random.default_rng(8)
    return [(rng.standard_normal((2, *shape)).astype(np.float32),
             (rng.standard_normal((2, *shape)) * 1e-3).astype(np.float32))
            for shape in COMPRESS_SHAPES]


# -------------------------------------------------------------- the runs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(every rank's outputs on the (2, 2) mesh, on the ("stage",) mesh,
    the references, the JAX mesh run, the compression's inputs).  The JAX
    subprocess and both meshes' ranks start first and run while this
    process computes the one-device references."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    cases, refs, todo = {}, {}, []
    for name, spec in {**ONE_DEVICE, **ON_MESH}.items():
        case, jm, jp, batch = rank_case("train_loss", *spec)
        cases[name] = case
        if name in ONE_DEVICE or name == "deepseek-mesh":
            todo.append((name, one_device_loss, (jm, jp, batch)))
    for name, fault in FAULTS.items():
        cases[name] = {**cases["mistral"], "fault": fault}
    for name, (arch, moe, mb, specs) in STEPS.items():
        case, jm, jp, batch = rank_case("train_step", arch, {}, moe, {},
                                        None, microbatches=mb,
                                        grad_specs=specs, peak_lr=PEAK_LR)
        cases[name] = case
        todo.append((name, one_device_step, (jm, jp, batch, mb)))
    compress = compress_inputs()
    for i, (g, e) in enumerate(compress):
        cases[f"compress{i}"] = {"kind": "compressed_psum",
                                 "grads": torch.from_numpy(g),
                                 "errors": torch.from_numpy(e)}
    gp = gpipe_inputs()
    stage_cases = {"gpipe": {"kind": "gpipe", "axis": "stage",
                             "params": {"w": torch.from_numpy(gp["w"]),
                                        "b": torch.from_numpy(gp["b"])},
                             "xs": torch.from_numpy(gp["xs"])}}
    jax_mesh = ranks.JaxRun(tmp, JAX_MESH, jax_mesh_inputs(cases, gp,
                                                           compress),
                            DEADLINE_S)
    try:
        with ThreadPoolExecutor(2) as pool:
            outs = pool.submit(ranks.spawn, cases, MESH, tmp / "ranks",
                               deadline=DEADLINE_S)
            stage = pool.submit(ranks.spawn, stage_cases, (GPIPE["S"],),
                                tmp / "stage", deadline=DEADLINE_S,
                                axes=("stage",))
            for name, fn, args in todo:
                refs[name] = fn(*args)
            outs, stage = outs.result(), stage.result()
        jax_out = jax_mesh.outputs()
    finally:
        jax_mesh.close()
    return outs, stage, refs, jax_out, compress


def same_on_every_rank(outs, name):
    """A case's outputs, after checking that every rank holds the same
    (each gradient gathered whole, each metric global)."""
    first = outs[(0, 0)][name]
    for c, o in outs.items():
        for k, v in first.items():
            if not k.startswith("bytes/"):
                assert torch.equal(o[name][k], v), (name, c, k)
    return first


def leaf_ratios(got, want, prefix, rel):
    """{leaf: max |port - reference| / (rel x max |reference|)} over the
    keys of ``want`` under ``prefix``; a leaf passes at <= 1."""
    keys = {k for k in want if k.startswith(prefix)}
    assert keys == {k for k in got if k.startswith(prefix)}, prefix
    out = {}
    for k in keys:
        w = np.asarray(want[k], np.float32)
        g = got[k].numpy()
        assert g.shape == w.shape, (k, g.shape, w.shape)
        out[k] = np.abs(g - w).max() / (rel * max(np.abs(w).max(), 1e-30))
    return out


def jax_mesh_refs(jax_out, name):
    pre = name + "/"
    return {k[len(pre):]: v for k, v in jax_out.items()
            if k.startswith(pre)}


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("name", list(ONE_DEVICE))
def test_loss_and_every_gradient_leaf_match_one_device(run, name):
    outs, _, refs, _, _ = run
    got, want = same_on_every_rank(outs, name), refs[name]
    np.testing.assert_allclose(got["loss"].item(), want["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["xent"].item(), want["xent"],
                               rtol=LOSS_RTOL)
    ratios = leaf_ratios(got, want, "g/", LEAF_REL)
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("name", list(ON_MESH))
def test_moe_loss_and_gradients_match_the_reference_on_a_mesh(run, name):
    outs, _, _, jax_out, _ = run
    got, want = same_on_every_rank(outs, name), jax_mesh_refs(jax_out, name)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["xent"].item(), float(want["xent"]),
                               rtol=LOSS_RTOL)
    ratios = leaf_ratios(got, want, "g/", LEAF_REL)
    assert max(ratios.values()) <= 1.0, ratios


def test_reference_mesh_moe_aux_is_each_data_shards(run):
    """The reference's MoE on a mesh takes its aux loss on each `data`
    shard and averages (its shard_map, ``src/repro/models/transformer.py:
    147-200``), which is not the one-device aux of the whole batch: its
    own mesh gradient of DeepSeek-V3's router leaves its one-device one by
    more than the limit, and the port's follows the mesh.  Without the aux
    (``deepseek-no-aux``) the port matches one device."""
    outs, _, refs, jax_out, _ = run
    mesh = jax_mesh_refs(jax_out, "deepseek-mesh")
    key = "g/layers/ffn/router"
    apart = leaf_ratios({key: torch.from_numpy(mesh[key])},
                        {key: refs["deepseek-mesh"][key]}, key, LEAF_REL)
    assert apart[key] > 1.0
    got = same_on_every_rank(outs, "deepseek-mesh")
    assert leaf_ratios(got, mesh, key, LEAF_REL)[key] <= 1.0


@pytest.mark.parametrize("name", list(FAULTS))
def test_a_broken_gradient_convention_fails_the_limit(run, name):
    """Each fault takes some gradient leaf far past its limit."""
    outs, _, refs, _, _ = run
    got = outs[(0, 0)][name]
    np.testing.assert_allclose(got["loss"].item(), refs["mistral"]["loss"],
                               rtol=LOSS_RTOL)
    ratios = leaf_ratios(got, refs["mistral"], "g/", LEAF_REL)
    assert max(ratios.values()) > 100, ratios


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_matches_one_device(run, name):
    """loss, grad_norm, the updated params and the moments after one step
    (arch, microbatches, grad_specs: ``STEPS``)."""
    outs, _, refs, _, _ = run
    got, want = same_on_every_rank(outs, name), refs[name]
    np.testing.assert_allclose(got["loss"].item(), want["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"].item(), want["grad_norm"],
                               rtol=LOSS_RTOL)
    for prefix, rel in (("p/", LEAF_REL), ("m/", LEAF_REL), ("v/", V_REL)):
        ratios = leaf_ratios(got, want, prefix, rel)
        assert max(ratios.values()) <= 1.0, (prefix, ratios)


@pytest.mark.parametrize("mb", [1, 2])
def test_grad_specs_reduce_by_psum_scatter_each_microbatch(run, mb):
    """With grad_specs the FSDP leaves' gradients reach each rank by
    reduce-scatters, every microbatch; without, by one all-reduce of the
    whole leaves after the last (and the leaves' gathers before the first,
    once)."""
    outs, *_ = run
    for c in outs:
        specs = outs[c][f"step-mb{mb}-specs"]
        whole = outs[c][f"step-mb{mb}"]
        assert specs["bytes/psum_scatter"] > 0
        assert whole["bytes/psum_scatter"] == 0
        assert whole["bytes/psum"] > specs["bytes/psum"]
    if mb == 2:
        one = outs[(0, 0)]["step-mb1-specs"]["bytes/psum_scatter"]
        two = outs[(0, 0)]["step-mb2-specs"]["bytes/psum_scatter"]
        assert two == 2 * one


def test_gpipe_forward_matches_reference(run):
    _, stage, _, jax_out, _ = run
    want = jax_out["gpipe"]
    g = GPIPE
    gp = gpipe_inputs()
    seq = gp["xs"]
    for s in range(g["S"]):
        seq = np.tanh(seq @ gp["w"][s] + gp["b"][s])
    for (s,), o in stage.items():
        np.testing.assert_allclose(o["gpipe"].numpy(), want, rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(o["gpipe"].numpy(), seq, rtol=2e-5,
                                   atol=2e-5)
    assert pipeline_bubble_fraction(4, 6) == 3 / 9
    assert pipeline_bubble_fraction(1, 8) == 0.0


@pytest.mark.parametrize("i", range(len(COMPRESS_SHAPES)))
def test_compress_with_feedback_and_compressed_psum_match_reference(run, i):
    outs, _, _, jax_out, compress = run
    grads, errors = compress[i]
    for (d, _), o in outs.items():
        got = o[f"compress{i}"]
        q, err = jquant.compress_with_feedback(jnp.asarray(grads[d]),
                                               jnp.asarray(errors[d]))
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(q.q))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(q.scale))
        np.testing.assert_array_equal(got["err"].numpy(), np.asarray(err))
        np.testing.assert_array_equal(got["err2"].numpy(), np.asarray(err))
        np.testing.assert_allclose(got["sum"].numpy(),
                                   jax_out[f"compress{i}/sum"][d],
                                   rtol=1e-6, atol=1e-6)
        # XLA fuses the jitted residual's product into its subtraction,
        # so the mesh run's residual differs from the eager one (above) in
        # the last bits
        np.testing.assert_allclose(got["err2"].numpy(),
                                   jax_out[f"compress{i}/err"][d],
                                   rtol=1e-6, atol=1e-6)
