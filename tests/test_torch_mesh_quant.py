"""AdamW's int8 moments on a ("data", "model") mesh against the JAX
package, on the CPU: four gloo ranks (``tests/torch_mesh_ranks.py``, one
thread each, never importing JAX) on a (2, 2) mesh, each training from
its FSDP and TP blocks of the reference's weights with
``AdamWConfig(quantized=True)``; every rank stores the reference's
blocks of each moment that ``train_state_specs`` gives it
(``quant.MomentPlan``).

Configs, f32, each in both layouts (shape-preserving blocks, and the
flat ``flat_moments``): mixtral-8x7b's smoke (experts over `model`,
capacity factor 16 and no aux loss, so that its per-shard routing is the
one device's) at vocab 512 and at vocab 1000, and Jamba's smoke cut to
one period (4 layers: attention at 2, MoE at 1 and 3, likewise without
drops or aux loss; the dense cut's empty MoE stack is a leaf the
reference's ``quantize`` cannot reshape).  Between them every case of the plan's occurs
(``test_the_cases_cover_every_kind_of_leaf``): aligned (a rank's entries
are whole blocks: the experts' uncut last dims, the 512-vocab
``lm_head``'s 256 columns a rank), replicated-unaligned (fewer than 256
columns a rank of a leaf with one block: ``wq``'s 32 of 64), sharded-
unaligned (the 1000-vocab ``lm_head``'s 500 columns a rank, its 4 blocks
2 a rank, block 1 straddling the ranks) and ``sharding.Parts`` (Mamba's
``in_proj``, a rank holding x's and z's second halves).  Two
``make_train_step`` steps of 4 rows of 16 tokens (2 rows a `data` rank),
2 microbatches, ``grad_specs``, so that the second step loads the
moments the first stored.

Held, against JAX's ``make_train_step`` at one device with the same
``AdamWConfig``:

* each step's loss and ``grad_norm`` within 2e-5 relative (the limit of
  ``tests/test_torch_mesh_train.py``);
* after each step, each moment's int8 values entry by entry: where one
  differs from the reference's (a flip) it must be one step away and sit
  at a rounding tie, the port's own f32 moment within the moment's limit
  (below) of a rounding boundary, unless its block held a flip at an
  earlier step (that block's scale and entries then carry the flip); every
  other entry's block scale within 1e-4 of the leaf's largest scale;
* after the last step, each moment dequantized and gathered whole,
  entry by entry within 1e-4 of the leaf's largest |entry| (m) or 2e-4
  (v, the square of the gradient: ``tests/test_torch_mesh_train.py``'s
  limit for f32 second moments), and each param within 1e-4 of its
  leaf's largest |entry|, but in the blocks that flipped: an int8 v of 0
  makes Adam's update m / eps there, so one flip moves such a param far
  past the limit.  The flips at ties and the params past the limit are
  counted (the test's ``user_properties``);
* the stored blocks gathered by ``train_state_specs``' ``q`` spec: the
  reference's shapes, and the values the plans load;
* the bytes the plans' gathers brought each rank in a step: those the
  plans' shapes give;
* ``train_state_specs`` against the reference's ``train_state_shardings``
  on a 4-device Auto-axes JAX mesh, in a subprocess;
* a one-rank mesh gives the port's one-device bits;
* a fault, each rank quantizing its own shard from its first entry
  (``torch_mesh_ranks._local_plans``), takes the scales past 100 times
  their limit.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import cosine as jcosine  # noqa: E402
from repro.optim import quant as jquant  # noqa: E402
from repro.training.step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.distribution import context as tctx  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig, cosine, quant  # noqa: E402
from repro_torch.training.step import (  # noqa: E402
    make_train_step, train_state_specs)

import torch_mesh_ranks as ranks  # noqa: E402
from test_torch_mesh_train import (  # noqa: E402
    LEAF_REL, LOSS_RTOL, V_REL, flat_np, same_on_every_rank)

MESH = (2, 2)
DEADLINE_S = 240
B, SEQ, STEPS, MICROBATCHES = 4, 16, 2, 2
PEAK_LR = 1e-5
SCALE_REL = 1e-4
FAULT_FACTOR = 100
MOMENT_REL = {"m": LEAF_REL, "v": V_REL}
NO_DROPS = {"capacity_factor": 16.0, "aux_loss_coef": 0.0}
# name: arch, config replacements, MoE overrides
MODELS = {"mixtral": ("mixtral-8x7b", {}, NO_DROPS),
          "mixtral-v1000": ("mixtral-8x7b", {"vocab_size": 1000}, NO_DROPS),
          "jamba": ("jamba-1.5-large-398b", {"n_layers": 4}, NO_DROPS)}
LAYOUTS = {"blocks": False, "flat": True}
CASES = [(m, lay) for m in MODELS for lay in LAYOUTS]
FAULT = ("mixtral-v1000", "blocks")
ONE_RANK = ("mixtral", "blocks")


def jax_cfg(name):
    arch, replace, moe = MODELS[name]
    cfg = get_smoke(arch).replace(dtype="float32", **replace)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))


@functools.lru_cache(maxsize=None)
def jax_model(name):
    jm = jax_build(jax_cfg(name))
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0))


def batches_np(cfg):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, (B, SEQ + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def torch_batches(batches):
    return [{k: torch.from_numpy(v).long() for k, v in b.items()}
            for b in batches]


def case_for(name, layout, **extra):
    arch, replace, moe = MODELS[name]
    _, jp = jax_model(name)
    return {"kind": "quant_step", "arch": arch, "dtype": "float32",
            "replace": replace, "moe": moe, "knobs": {},
            "params": params_from_flat(flat_np(jp)),
            "batches": torch_batches(batches_np(jax_cfg(name))),
            "microbatches": MICROBATCHES, "flat": LAYOUTS[layout],
            "peak_lr": PEAK_LR, **extra}


def entries(blocks, shape, flat):
    """Each entry's value of a per-block array (..., nb, 1 or 256): its
    block's scale or its int8 value, in the leaf's shape."""
    blocks = np.broadcast_to(blocks, (*blocks.shape[:-1], quant.BLOCK))
    if flat and len(shape) != 1:
        return blocks.reshape(-1)[:math.prod(shape)].reshape(shape)
    lead = blocks.shape[:-2]
    full = blocks.reshape(*lead, -1)[..., :shape[-1] if shape else 1]
    return full.reshape(shape)


def one_device_steps(name, layout):
    """JAX's make_train_step at one device, quantized: each step's loss
    and grad_norm and, after it, each moment's int8 value and block scale
    by entry ("mq/i/<path>", "ms/i/<path>") and the params ("p/i/<path>");
    after the last step the
    params and each moment dequantized and by block ("mblk/<path>/q",
    "/scale")."""
    jm, jp = jax_model(name)
    flat = LAYOUTS[layout]
    opt = JAdamW(lambda s: jcosine(s, peak_lr=PEAK_LR, warmup=2, total=10),
                 JAdamWConfig(quantized=True, flat_moments=flat))
    step = jax.jit(jax_train_step(jm, opt, microbatches=MICROBATCHES))
    p, state, out = jp, opt.init(jp), {}

    def moments(key):
        leaves = jax.tree_util.tree_flatten_with_path(
            state[key], is_leaf=jquant.is_qtensor)[0]
        return [("/".join(str(k.key) for k in path), qt)
                for path, qt in leaves]

    for i, b in enumerate(batches_np(jm.cfg)):
        p, state, m = step(p, state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        out[f"loss/{i}"] = float(m["loss"])
        out[f"grad_norm/{i}"] = float(m["grad_norm"])
        out.update({f"p/{i}/{k}": v for k, v in flat_np(p).items()})
        for key in ("m", "v"):
            for path, qt in moments(key):
                out[f"{key}q/{i}/{path}"] = entries(np.asarray(qt.q),
                                                    qt.shape, flat)
                out[f"{key}s/{i}/{path}"] = entries(np.asarray(qt.scale),
                                                    qt.shape, flat)
    out.update({f"p/{k}": v for k, v in flat_np(p).items()})
    for key in ("m", "v"):
        for path, qt in moments(key):
            out[f"{key}/{path}"] = np.asarray(jquant.dequantize(qt))
            out[f"{key}blk/{path}/q"] = np.asarray(qt.q)
            out[f"{key}blk/{path}/scale"] = np.asarray(qt.scale)
    return out


# ----------------------------------------- the reference's moment specs

JAX_SPECS = """
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke
from repro.distribution.context import make_context
from repro.models.factory import build_model
from repro.optim import AdamW, AdamWConfig, quant
from repro.training.step import train_state_shardings
io = dict(np.load(sys.argv[1], allow_pickle=True))
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for name in io["names"]:
    arch, replace, moe = io[name + "/spec"].tolist()
    cfg = get_smoke(arch).replace(dtype="float32", **replace)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    model = build_model(cfg, make_context(mesh))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    for flat in (False, True):
        opt = AdamW(lambda s: 0.0, AdamWConfig(quantized=True,
                                               flat_moments=flat))
        _, osh = train_state_shardings(model, shapes,
                                       jax.eval_shape(opt.init, shapes))
        specs = {}
        for key in ("m", "v"):
            leaves = jax.tree_util.tree_flatten_with_path(
                osh[key], is_leaf=quant.is_qtensor)[0]
            for path, qt in leaves:
                p = "/".join(str(k.key) for k in path)
                specs[f"{key}/{p}"] = [list(qt.q.spec), list(qt.scale.spec)]
        out[f"{name}/{int(flat)}"] = np.array(json.dumps(specs))
np.savez(sys.argv[2], **out)
"""


def jax_specs_inputs():
    io = {"names": np.array(list(MODELS))}
    for name, spec in MODELS.items():
        io[name + "/spec"] = np.array(spec, dtype=object)
    return io


# -------------------------------------------------------------- the runs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(every rank's outputs on the (2, 2) mesh, the one-rank mesh's, the
    references, the reference's moment specs).  The JAX subprocess and
    both spawns start first and run while this process computes the
    references."""
    tmp = tmp_path_factory.mktemp("mesh_quant")
    cases = {f"{m}-{lay}": case_for(m, lay) for m, lay in CASES}
    cases["fault"] = case_for(*FAULT, fault="local-quantize")
    one_rank = {"one-rank": case_for(*ONE_RANK)}
    jax_specs = ranks.JaxRun(tmp, JAX_SPECS, jax_specs_inputs(), DEADLINE_S)
    try:
        with ThreadPoolExecutor(2) as pool:
            outs = pool.submit(ranks.spawn, cases, MESH, tmp / "ranks",
                               deadline=DEADLINE_S)
            outs1 = pool.submit(ranks.spawn, one_rank, (1, 1),
                                tmp / "one_rank", deadline=DEADLINE_S)
            refs = {f"{m}-{lay}": one_device_steps(m, lay)
                    for m, lay in CASES}
            refs["one-rank"] = port_one_device(*ONE_RANK)
            outs, outs1 = outs.result(), outs1.result()
        specs = {k: json.loads(str(v))
                 for k, v in jax_specs.outputs().items()}
    finally:
        jax_specs.close()
    return outs, outs1, refs, specs


def port_one_device(name, layout):
    """The port's make_train_step at one device on the same case: params
    and each moment's q and scale (no mesh, no plan)."""
    case = case_for(name, layout)
    cfg = port_smoke(case["arch"]).replace(dtype="float32",
                                           **case["replace"])
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **case["moe"]))
    model = build_model(cfg)
    opt = AdamW(lambda s: cosine(s, peak_lr=PEAK_LR, warmup=2, total=10),
                AdamWConfig(quantized=True, flat_moments=case["flat"]))
    step = make_train_step(model, opt, microbatches=MICROBATCHES)
    params = case["params"]
    state = opt.init(params)
    out = {}
    for i, b in enumerate(case["batches"]):
        params, state, m = step(params, state, b)
        out[f"loss/{i}"], out[f"grad_norm/{i}"] = m["loss"], m["grad_norm"]
    out.update({f"p/{k}": v for k, v in T.flatten(params)})
    for key in ("m", "v"):
        for path, qt in T.flatten(state[key], quant.is_qtensor):
            out[f"{key}blk/{path}/q"] = qt.q
            out[f"{key}blk/{path}/scale"] = qt.scale
    return out


# ---------------------------------------------------------------- checks


def _fake_dist(sizes, coords):
    """A mesh context of ``sizes`` at the rank ``coords``: what the rule
    table and ``MomentPlan`` read."""
    def names(axes):
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def axis_index(axes):
        idx = 0
        for a in names(axes):
            idx = idx * sizes[a] + coords[a]
        return idx

    comm = SimpleNamespace(
        names=tuple(sizes), axis_index=axis_index,
        axis_size=lambda axes: math.prod(sizes[a] for a in names(axes)))
    mesh = SimpleNamespace(shape=tuple(sizes.values()),
                           mesh_dim_names=tuple(sizes))
    return tctx.make_context(mesh, comm=comm)


def port_model(name, dist):
    arch, replace, moe = MODELS[name]
    cfg = port_smoke(arch).replace(dtype="float32", **replace)
    return build_model(cfg.replace(moe=dataclasses.replace(cfg.moe, **moe)),
                       dist)


@functools.lru_cache(maxsize=None)
def plans_of(name, layout, coords=(0, 0)):
    """{path: MomentPlan} of the rank at ``coords`` of the (2, 2) mesh."""
    dist = _fake_dist({"data": MESH[0], "model": MESH[1]},
                      dict(zip(("data", "model"), coords)))
    model = port_model(name, dist)
    specs, shapes = model.layout()
    return dict(T.flatten(quant.moment_plans(specs, shapes, dist,
                                             LAYOUTS[layout])))


def kind(plan):
    if plan.aligned:
        return "aligned"
    if not plan.flat and plan.parts > 1:
        return "parts"
    return "sharded-unaligned" if plan.blk_axes else "replicated-unaligned"


def test_the_cases_cover_every_kind_of_leaf():
    kinds = {lay: {kind(p) for m in MODELS
                   for p in plans_of(m, lay).values()} for lay in LAYOUTS}
    assert kinds["blocks"] == {"aligned", "replicated-unaligned",
                               "sharded-unaligned", "parts"}
    # every flat leaf that a rule cuts has an even block count here
    assert kinds["flat"] == {"aligned", "sharded-unaligned"}
    head = plans_of("mixtral-v1000", "blocks")["embed/lm_head"]
    assert kind(head) == "sharded-unaligned" and (head.b0, head.b1) == (0, 2)
    assert kind(plans_of("mixtral", "blocks")["embed/lm_head"]) == "aligned"


@pytest.mark.parametrize("name,layout", CASES)
def test_losses_and_norms_match_one_device(run, name, layout):
    outs, _, refs, _ = run
    key = f"{name}-{layout}"
    got, want = same_on_every_rank(outs, key), refs[key]
    for i in range(STEPS):
        for metric in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[f"{metric}/{i}"].item(),
                                       want[f"{metric}/{i}"],
                                       rtol=LOSS_RTOL)


def block_any(mask, shape, flat):
    """Each entry: whether any entry of its block is set."""
    B_ = quant.BLOCK
    if flat and len(shape) != 1:
        f = np.pad(mask.reshape(-1), (0, (-mask.size) % B_))
        return np.repeat(f.reshape(-1, B_).any(-1), B_)[:mask.size].reshape(
            shape)
    pad = [(0, 0)] * (mask.ndim - 1) + [(0, (-shape[-1]) % B_)]
    f = np.pad(mask, pad).reshape(*shape[:-1], -1, B_).any(-1)
    return np.repeat(f, B_, axis=-1)[..., :shape[-1]]


def moment_flips(got, want, key, path, flat):
    """Walks the steps of one moment leaf: at each, the entries whose int8
    value differs from the reference's (flips) must be one step apart and
    at a tie (the port's f32 moment within the moment's limit of a
    rounding boundary) or in a block that held a flip at an earlier step
    (its scale and its entries then carry that flip); every other entry's
    block scale within SCALE_REL of the leaf's largest.  Returns (the
    entries in a block that flipped at some step, the flips at ties, the
    worst scale ratio)."""
    rel = MOMENT_REL[key]
    shape = want[f"{key}/{path}"].shape
    earlier = np.zeros(shape, bool)
    n_ties, worst = 0, 0.0
    for i in range(STEPS):
        dq = (got[f"{key}q/{i}/{path}"].numpy()
              - want[f"{key}q/{i}/{path}"])
        s = got[f"{key}s/{i}/{path}"].double().numpy()
        x = got[f"pre/{key}/{i}/{path}"].double().numpy()
        frac = x / s - np.floor(x / s)
        tie = np.abs(frac - 0.5) * s <= rel * np.abs(x).max(initial=0)
        flipped = dq != 0
        at_tie = flipped & ~earlier & (np.abs(dq) == 1) & tie
        bad = flipped & ~earlier & ~at_tie
        assert not bad.any(), (key, path, i, int(bad.sum()),
                               np.argwhere(bad)[:3].tolist())
        sw = np.asarray(want[f"{key}s/{i}/{path}"], np.float64)
        ratio = (np.abs(s - sw) * ~earlier).max(initial=0) / (
            SCALE_REL * sw.max())
        worst = max(worst, ratio)
        n_ties += int(at_tie.sum())
        earlier |= block_any(flipped, shape, flat)
    return earlier, n_ties, worst


def beyond_adam_bound(name, path, runs):
    """The entries where some step's update, read off the params of
    ``runs`` (each {"p/i/<path>"}: the reference's, the port's), passes
    Adam's bound.  With f32 moments |m_hat / sqrt(v_hat)| <= 1.0007 at
    steps 1 and 2 (Cauchy-Schwarz, b1 ** 2 <= b2); an int8 v that rounded
    an entry's history to 0 leaves sqrt(v_hat) at its new gradient alone,
    and the update, m_hat over it, as ill-conditioned as that gradient is
    small.  The update is (p_prev - p) / lr less the decay, each p's f32
    spacing allowed twice."""
    _, jp = jax_model(name)
    first = flat_np(jp)[path].astype(np.float64)
    out = np.zeros(first.shape, bool)
    for run in runs:
        prev = first
        for i in range(STEPS):
            p = np.asarray(run[f"p/{i}/{path}"], np.float64)
            lr = float(jcosine(jnp.asarray(i + 1), peak_lr=PEAK_LR,
                               warmup=2, total=10))
            u = (prev - p) / lr
            if p.ndim >= 2:
                u -= JAdamWConfig().weight_decay * prev
            slack = 2 * np.spacing(np.abs(prev).astype(np.float32)) / lr
            out |= np.abs(u) - slack > 1.01
            prev = p
    return out


@pytest.mark.parametrize("name,layout", CASES)
def test_moments_and_params_match_one_device_but_for_flips_at_ties(
        run, name, layout, request):
    """Each moment's flips at ties (``moment_flips``) and block scales;
    after the last step each moment, dequantized, within its limit but in
    the blocks that flipped, and each param within 1e-4 of its leaf's
    largest |entry| but where a moment's block flipped or an update passed
    Adam's bound (``beyond_adam_bound``) on either side."""
    outs, _, refs, _ = run
    key_ = f"{name}-{layout}"
    got, want = same_on_every_rank(outs, key_), refs[key_]
    got_np = {k: v.numpy() for k, v in got.items() if k.startswith("p/")}
    flat = LAYOUTS[layout]
    n_ties = n_flipped = n_beyond = 0
    worst = {}
    for path in [k[2:] for k in want
                 if k.startswith("p/") and not k.split("/")[1].isdigit()]:
        affected = np.zeros(want[f"p/{path}"].shape, bool)
        for key in ("m", "v"):
            flipped, ties, worst[f"{key}s/{path}"] = moment_flips(
                got, want, key, path, flat)
            w = np.asarray(want[f"{key}/{path}"], np.float64)
            over = np.abs(got[f"{key}/{path}"].double().numpy() - w) > (
                MOMENT_REL[key] * np.abs(w).max(initial=0))
            assert not (over & ~flipped).any(), (key, path)
            affected |= flipped
            n_ties += ties
        beyond = beyond_adam_bound(name, path, (want, got_np))
        w = np.asarray(want[f"p/{path}"], np.float64)
        over = np.abs(got[f"p/{path}"].double().numpy() - w) > (
            LEAF_REL * np.abs(w).max(initial=0))
        assert not (over & ~affected & ~beyond).any(), (
            path, int((over & ~affected & ~beyond).sum()))
        n_flipped += int((over & affected).sum())
        n_beyond += int((over & beyond & ~affected).sum())
    assert max(worst.values()) <= 1.0, worst
    request.node.user_properties += [
        ("int8_flips_at_ties", n_ties),
        ("params_past_the_limit_in_flipped_blocks", n_flipped),
        ("params_past_the_limit_beyond_adam_bound", n_beyond)]


@pytest.mark.parametrize("name,layout", CASES)
def test_stored_blocks_are_the_reference_spec_blocks(run, name, layout):
    """The stored blocks gathered by ``train_state_specs``' ``q`` spec have
    the reference's shapes and are the entries' int8 values and scales
    the plans load."""
    outs, _, refs, _ = run
    key_ = f"{name}-{layout}"
    got, want = same_on_every_rank(outs, key_), refs[key_]
    flat = LAYOUTS[layout]
    last = STEPS - 1
    for key in ("m", "v"):
        for path in [k[len(key) + 1:] for k in want
                     if k.startswith(f"{key}/")]:
            q, sc = (got[f"{key}blk/{path}/{n}"] for n in ("q", "scale"))
            assert tuple(q.shape) == want[f"{key}blk/{path}/q"].shape
            assert tuple(sc.shape) == want[f"{key}blk/{path}/scale"].shape
            shape = want[f"{key}/{path}"].shape
            assert np.array_equal(entries(q.numpy(), shape, flat),
                                  got[f"{key}q/{last}/{path}"].numpy())
            assert np.array_equal(entries(sc.numpy(), shape, flat),
                                  got[f"{key}s/{last}/{path}"].numpy())


@pytest.mark.parametrize("name,layout", CASES)
def test_gathered_bytes_are_the_plans(run, name, layout):
    """Each rank's gathers in a step: for each moment of each leaf that is
    not aligned, the f32 entries of the span it lacks (stored) and, where
    its blocks are cut, the blocks it lacks (loaded)."""
    outs, _, _, _ = run
    for coords, out in outs.items():
        want = 0
        for plan in plans_of(name, layout, coords).values():
            if plan.aligned:
                continue
            local = math.prod(plan.local_shape)
            span = (math.prod(plan.shape) if plan.flat
                    else local // plan.local_shape[-1] * plan.shape[-1])
            want += (span - local) * 4
            if plan.blk_axes:
                rows = 1 if plan.flat else local // plan.local_shape[-1]
                nb = quant.n_blocks(plan.shape, plan.flat)
                want += rows * (nb - (plan.b1 - plan.b0)) * (
                    quant.BLOCK + 4)
        assert out[f"{name}-{layout}"]["gathered_bytes"].item() == 2 * want
        assert want > 0


@pytest.mark.parametrize("name", list(MODELS))
def test_train_state_specs_match_the_reference(run, name):
    _, _, _, specs = run
    dist = _fake_dist({"data": MESH[0], "model": MESH[1]},
                      {"data": 0, "model": 0})
    model = port_model(name, dist)
    shapes = model.init(None, "meta")
    for flat in (False, True):
        opt = AdamW(lambda s: 0.0, AdamWConfig(quantized=True,
                                               flat_moments=flat))
        _, ospecs = train_state_specs(model, shapes, opt.init(shapes))
        got = {}
        for key in ("m", "v"):
            for path, qt in T.flatten(ospecs[key], quant.is_qtensor):
                got[f"{key}/{path}"] = [list(qt.q), list(qt.scale)]
        want = specs[f"{name}/{int(flat)}"]
        norm = lambda sp: [[tuple(e) if isinstance(e, list) else e  # noqa
                            for e in s] for s in sp]
        assert {k: norm(v) for k, v in got.items()} == {
            k: norm(v) for k, v in want.items()}, (name, flat)


def test_one_rank_mesh_gives_one_device_bits(run):
    _, outs1, refs, _ = run
    got, want = outs1[(0, 0)]["one-rank"], refs["one-rank"]
    assert got["gathered_bytes"].item() == 0
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_each_rank_quantizing_its_own_shard_fails_the_scales(run):
    """At the first step (no flip before it) the fault's block scales
    against the reference's."""
    outs, _, refs, _ = run
    got = outs[(0, 0)]["fault"]
    want = refs["-".join(FAULT)]
    worst = 0.0
    for k in want:
        if k.startswith(("ms/0/", "vs/0/")):
            w = np.asarray(want[k], np.float64)
            g = got[k].double().numpy()
            worst = max(worst, np.abs(g - w).max() / (SCALE_REL * w.max()))
    assert worst > FAULT_FACTOR, worst
