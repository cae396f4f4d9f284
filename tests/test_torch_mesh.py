"""The port's mesh path against the JAX package, on the CPU: four gloo
ranks (``tests/torch_mesh_ranks.py``, one thread each, never importing
JAX) on ("data", "model") meshes of (2, 2) and (1, 4), rendezvousing
through a ``FileStore`` under the test's tmp_path (no port to pick under
xdist).  The test writes the cases' full weights and inputs, each rank
cuts its shards and runs every case, and the test joins the ranks with a
deadline, so a hung rendezvous fails its tests instead of eating the
suite's time.

Held: ``decode_attention_sp`` and ``mla_decode_sp`` against the JAX
package's own SP functions on a 4-device JAX mesh (a subprocess with
``--xla_force_host_platform_device_count=4``, Auto axes built inside it)
and against the one-device decode; ``apply_moe`` in its expert-parallel,
tensor-parallel and full expert-parallel modes (through ``DecoderLM._moe``,
the reference's mesh branch) against the reference's one-device
``apply_moe``; ``DecoderLM`` prefill and teacher-forced decode on a mesh
against the reference's model without one (mistral-nemo with
``sp_decode``; DeepSeek-V3 with ``sp_decode`` and ``moe_full_ep``;
mixtral with EP, ``window_cache`` and a prompt whose decode wraps the
ring; mixtral with 3 experts, which divide no `model` size, so its MoE
runs tensor-parallel, and without ``sp_decode``, so decode all-gathers
the cache).  f32 at 2e-5, bf16 at 5e-2 (the reference's own mesh test,
test_distributed.py:67).

Capacity: on (1, 4) every rank routes every token, so the published
capacity factor (1.25) drops exactly what one device drops.  On (2, 2)
EP and TP cap each `data` shard's tokens on their own, by the
reference's design, so they drop other assignments than one device:
there those cases use capacity factor 16 (no drops), as the reference's
mesh test does (test_distributed.py:49-51).  Full EP gathers the tokens
over `data` first, so it keeps the published factor on both meshes.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import moe as jM  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402

MESHES = [(2, 2), (1, 4)]
MESH_IDS = ["2x2", "1x4"]
DEADLINE_S = 240
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
NO_DROPS = 16.0

# DecoderLM cases: arch, MoE overrides, knobs, dtype, batch, prompt,
# forced decode steps, max_len
DECODER = {
    "mistral-sp-f32": ("mistral-nemo-12b", {}, {"sp_decode": True},
                       "float32", 4, 12, 4, 24),
    "mistral-sp-bf16": ("mistral-nemo-12b", {}, {"sp_decode": True},
                        "bfloat16", 4, 12, 4, 24),
    "deepseek-sp-fullep": ("deepseek-v3-671b", {},
                           {"sp_decode": True, "moe_full_ep": True},
                           "float32", 4, 12, 4, 24),
    # window 16, a ring of 16 slots: 12 prompt tokens, 8 steps wrap it
    "mixtral-ep-ring": ("mixtral-8x7b", {}, {"sp_decode": True,
                                             "window_cache": True},
                        "float32", 4, 12, 8, 16),
    "mixtral-tp": ("mixtral-8x7b", {"n_experts": 3}, {}, "float32", 4, 12,
                   4, 24),
}
MOE_MODES = ("ep", "tp", "full_ep")
# decode_attention_sp cases: dtype, window, softcap
SP = {"sp-f32": ("float32", 0, 0.0), "sp-bf16": ("bfloat16", 0, 0.0),
      "sp-window-softcap": ("float32", 9, 30.0)}
SP_SHAPE = dict(b=4, S=32, nq=8, nkv=2, hd=16, length=27)


def capacity(mode, mesh):
    """The capacity factor a MoE case runs at (module docstring)."""
    return NO_DROPS if mesh == (2, 2) and mode != "full_ep" else None


def jax_cfg(arch, dtype, moe=None):
    cfg = get_smoke(arch).replace(dtype=dtype)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def on_grid(a, dtype):
    """``a`` as f32 values that ``dtype`` holds exactly, so both packages
    start from the same numbers."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(getattr(torch, dtype)).float().numpy()


def torch_params(jparams):
    return params_from_flat({k: np.asarray(v) for k, v in
                             _flatten(jparams)})


# ------------------------------------------------------------------- cases


def decoder_case(name, mesh):
    """(rank inputs, the reference's logits (b, 1 + steps, V))."""
    arch, _, knobs, *_ = DECODER[name]
    factor = None
    if get_smoke(arch).moe is not None and not knobs.get("moe_full_ep"):
        factor = capacity("ep", mesh)
    return _decoder_case(name, factor)


@functools.lru_cache(maxsize=None)
def _decoder_case(name, factor):
    arch, moe, knobs, dtype, b, s, steps, max_len = DECODER[name]
    moe = dict(moe, **({"capacity_factor": factor} if factor else {}))
    cfg = jax_cfg(arch, dtype, moe)
    jm = jax_build(cfg)
    jm.window_cache = bool(knobs.get("window_cache"))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (b, steps)).astype(np.int32)
    logits, cache, length = jax.jit(lambda p, t: jm.prefill(p, t, max_len))(
        jp, jnp.asarray(toks))
    out = [np.asarray(logits, np.float32)]
    step = jax.jit(jm.decode)
    for i in range(steps):
        logits, cache, length = step(jp, cache,
                                     jnp.asarray(forced[:, i:i + 1]), length)
        out.append(np.asarray(logits, np.float32))
    inputs = {"kind": "decoder", "arch": arch, "dtype": dtype, "moe": moe,
              "knobs": knobs, "params": torch_params(jp),
              "tokens": torch.from_numpy(toks).long(),
              "forced": torch.from_numpy(forced).long(), "max_len": max_len}
    return inputs, np.concatenate(out, axis=1)


def moe_case(mode, mesh):
    """apply_moe on DeepSeek-V3's smoke MoE (8 experts, one shared):
    (rank inputs, the reference's one-device (y, aux))."""
    return _moe_case(mode, capacity(mode, mesh))


@functools.lru_cache(maxsize=None)
def _moe_case(mode, factor):
    moe = {"capacity_factor": factor} if factor else {}
    cfg = jax_cfg("deepseek-v3-671b", "float32", moe)
    jp = jM.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    x = np.random.default_rng(4).standard_normal(
        (4, 10, cfg.d_model)).astype(np.float32)
    y, aux = jM.apply_moe(jnp.asarray(x), jp, cfg)
    inputs = {"kind": "moe", "arch": "deepseek-v3-671b", "dtype": "float32",
              "moe": moe, "knobs": {}, "mode": mode,
              "params": torch_params(jp), "x": torch.from_numpy(x)}
    return inputs, (np.asarray(y), float(aux))


def sp_inputs(dtype):
    d = SP_SHAPE
    rng = np.random.default_rng(5)
    q = on_grid(rng.standard_normal((d["b"], 1, d["nq"], d["hd"])), dtype)
    k = on_grid(rng.standard_normal((d["b"], d["S"], d["nkv"], d["hd"])),
                dtype)
    v = on_grid(rng.standard_normal((d["b"], d["S"], d["nkv"], d["hd"])),
                dtype)
    return q, k, v


@functools.lru_cache(maxsize=None)
def sp_case(name):
    """(rank inputs, the one-device decode's output)."""
    dtype, window, softcap = SP[name]
    q, k, v = sp_inputs(dtype)
    jdt = getattr(jnp, dtype)
    g = SP_SHAPE["nq"] // SP_SHAPE["nkv"]
    one = jA.decode_attention(
        jnp.asarray(q, jdt), jnp.repeat(jnp.asarray(k, jdt), g, axis=2),
        jnp.repeat(jnp.asarray(v, jdt), g, axis=2), SP_SHAPE["length"],
        window=window, softcap=softcap)
    t = {n: torch.from_numpy(a).to(getattr(torch, dtype))
         for n, a in (("q", q), ("k", k), ("v", v))}
    inputs = {"kind": "sp_decode", "length": SP_SHAPE["length"],
              "window": window, "softcap": softcap, **t}
    return inputs, np.asarray(one, np.float32)


@functools.lru_cache(maxsize=None)
def mla_case():
    """mla_decode_sp on DeepSeek-V3's smoke layer 0 (f32): (rank inputs,
    the one-device mla_decode's output)."""
    cfg = jax_cfg("deepseek-v3-671b", "float32")
    jm = jax_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    ap = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    x, ckv, krope, length = mla_inputs(cfg)
    pos = jnp.full((x.shape[0], 1), length - 1, jnp.int32)
    one = jA.mla_decode(jnp.asarray(x), ap, cfg, jnp.asarray(ckv),
                        jnp.asarray(krope), length, pos)
    inputs = {"kind": "mla_sp", "arch": "deepseek-v3-671b",
              "dtype": "float32", "moe": {}, "knobs": {"sp_decode": True},
              "params": torch_params(jp), "x": torch.from_numpy(x),
              "ckv": torch.from_numpy(ckv), "krope": torch.from_numpy(krope),
              "length": length}
    return inputs, np.asarray(one, np.float32)


def mla_inputs(cfg):
    m, rng = cfg.mla, np.random.default_rng(6)
    x = rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((4, 32, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((4, 32, m.qk_rope_head_dim)).astype(
        np.float32)
    return x, ckv, krope, 21


# the JAX package's own SP functions on a 4-device mesh of Auto axes
JAX_SP = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke
from repro.distribution.context import make_context
from repro.models import attention as A
from repro.models.factory import build_model
io = dict(np.load(sys.argv[1]))
out = {}
cfg = get_smoke("deepseek-v3-671b").replace(dtype="float32")
ap = jax.tree.map(lambda a: a[0],
                  build_model(cfg).init(jax.random.PRNGKey(0))["layers"]["attn"])
for shape in ((2, 2), (1, 4)):
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    dist = make_context(mesh, kv_seq=("model",))
    tag = f"{shape[0]}x{shape[1]}"
    for name in io["sp_names"]:
        dt = getattr(jnp, str(io[name + "/dtype"]))
        q, k, v = (jnp.asarray(io[f"{name}/{t}"], dt) for t in "qkv")
        o = A.decode_attention_sp(q, k, v, int(io["length"]), dist,
                                  window=int(io[name + "/window"]),
                                  softcap=float(io[name + "/softcap"]))
        out[f"{tag}/{name}"] = np.asarray(o, np.float32)
    x = jnp.asarray(io["mla/x"])
    L = int(io["mla/length"])
    pos = jnp.full((x.shape[0], 1), L - 1, jnp.int32)
    o = A.mla_decode_sp(x, ap, cfg, jnp.asarray(io["mla/ckv"]),
                        jnp.asarray(io["mla/krope"]), L, pos, dist)
    out[f"{tag}/mla"] = np.asarray(o, np.float32)
np.savez(sys.argv[2], **out)
"""


def start_jax_sp(tmp):
    """The JAX package's SP functions on both meshes (``JAX_SP``, a
    ``ranks.JaxRun``): ``outputs()`` waits for {"2x2/sp-f32": ...,
    "1x4/mla": ...}."""
    io = {"sp_names": np.array(list(SP)), "length": SP_SHAPE["length"]}
    for name, (dtype, window, softcap) in SP.items():
        for t, a in zip("qkv", sp_inputs(dtype)):
            io[f"{name}/{t}"] = a
        io[f"{name}/dtype"], io[f"{name}/window"] = dtype, window
        io[f"{name}/softcap"] = softcap
    x, ckv, krope, length = mla_inputs(jax_cfg("deepseek-v3-671b",
                                               "float32"))
    io.update({"mla/x": x, "mla/ckv": ckv, "mla/krope": krope,
               "mla/length": length})
    return ranks.JaxRun(tmp, JAX_SP, io, DEADLINE_S)


@pytest.fixture(scope="module")
def jax_sp_run(tmp_path_factory):
    run = start_jax_sp(tmp_path_factory.mktemp("jax_sp"))
    yield run
    run.close()


# -------------------------------------------------------------- the ranks


@pytest.fixture(scope="module", params=MESHES, ids=MESH_IDS)
def mesh_run(request, tmp_path_factory, jax_sp_run):
    """(mesh, every rank's outputs, the references) for one mesh."""
    mesh = request.param
    cases, refs = {}, {}
    for name in DECODER:
        cases[name], refs[name] = decoder_case(name, mesh)
    for mode in MOE_MODES:
        cases[f"moe-{mode}"], refs[f"moe-{mode}"] = moe_case(mode, mesh)
    for name in SP:
        cases[name], refs[name] = sp_case(name)
    cases["mla"], refs["mla"] = mla_case()
    cases["staged"] = {**cases["mistral-sp-bf16"], "staged": True}
    tmp = tmp_path_factory.mktemp(f"mesh{mesh[0]}x{mesh[1]}")
    return mesh, ranks.spawn(cases, mesh, tmp, deadline=DEADLINE_S), refs, \
        jax_sp_run


def close(ref, got, dtype):
    np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                               **TOL[dtype])


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("name", list(SP))
def test_decode_attention_sp_matches_reference(mesh_run, name):
    mesh, outs, refs, jax_sp = mesh_run
    got = ranks.by_rows(outs, name, mesh).numpy()
    dtype = SP[name][0]
    close(refs[name], got, dtype)          # the one-device decode
    close(jax_sp.outputs()[f"{mesh[0]}x{mesh[1]}/{name}"], got, dtype)


def test_mla_decode_sp_matches_reference(mesh_run):
    mesh, outs, refs, jax_sp = mesh_run
    got = ranks.by_rows(outs, "mla", mesh)
    close(refs["mla"], got, "float32")
    close(jax_sp.outputs()[f"{mesh[0]}x{mesh[1]}/mla"], got, "float32")


@pytest.mark.parametrize("mode", MOE_MODES)
def test_apply_moe_mesh_modes_match_reference(mesh_run, mode):
    mesh, outs, refs, _ = mesh_run
    y_ref, aux_ref = refs[f"moe-{mode}"]
    n = y_ref.size // mesh[0]
    blocks = []
    for di in range(mesh[0]):
        got = outs[(di, 0)][f"moe-{mode}"]
        for mi in range(1, mesh[1]):
            assert torch.equal(outs[(di, mi)][f"moe-{mode}"], got)
        blocks.append(got[:n])
        if mesh[0] == 1 or mode == "full_ep":
            # every rank routed every token: the one-device aux loss
            np.testing.assert_allclose(float(got[n]), aux_ref, rtol=2e-5)
    close(y_ref, torch.cat(blocks).numpy().reshape(y_ref.shape), "float32")


@pytest.mark.parametrize("name", list(DECODER))
def test_decoder_lm_prefill_decode_on_mesh_match_reference(mesh_run, name):
    mesh, outs, refs, _ = mesh_run
    close(refs[name], ranks.by_rows(outs, name, mesh), DECODER[name][3])


def test_staged_collectives_give_the_same_logits(mesh_run):
    """The collectives' staging through host memory (gloo over CUDA),
    taken here from CPU to CPU: the same bits as without, every operand
    left as it was."""
    mesh, outs, _, _ = mesh_run
    for c, o in outs.items():
        assert torch.equal(o["staged"], o["mistral-sp-bf16"]), c
