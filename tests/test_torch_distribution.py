"""The port's distribution layer against the JAX package, in one process:
the partition rule table (every smoke arch's params, on meshes of (2, 4),
(1, 4) and (4, 1), with the default knobs and with the serving knobs of
``optimized_overrides``), ``moe_param_specs``, ``cache_specs`` (DecoderLM
and Whisper), ``batch_specs``, ``make_context`` and
``optimized_overrides``; and ``shard_params``' blocks.

Both rule tables read only a mesh's axis names and sizes, so stand-ins
with those attributes serve as meshes: the reference's reads
``mesh.shape[name]`` and ``mesh.axis_names``, the port's (a
``DeviceMesh``'s) ``mesh.shape`` and ``mesh.mesh_dim_names``.  Nothing in
the JAX package changes."""
from __future__ import annotations

import itertools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, SHAPES, get_smoke  # noqa: E402
from repro.distribution import context as jctx  # noqa: E402
from repro.distribution import sharding as jS  # noqa: E402
from repro.launch.specs import optimized_overrides as j_overrides  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro.models.whisper import WhisperLM as JWhisper  # noqa: E402
from repro_torch.configs import get_smoke as port_smoke  # noqa: E402
from repro_torch.distribution import context as tctx  # noqa: E402
from repro_torch.distribution import sharding as tS  # noqa: E402
from repro_torch.launch.specs import optimized_overrides  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.models.whisper import WhisperLM  # noqa: E402

MESHES = [(2, 4), (1, 4), (4, 1)]
AXES = ("data", "model")
# what the rule table reads of a model besides cfg and dist
KNOB_ATTRS = ("shard_heads", "moe_ep", "moe_full_ep", "full_ep_available",
              "no_fsdp_experts", "no_mla_colshard")


def contexts(shape, names=AXES, **kw):
    """(the reference's context, the port's) over stand-in meshes."""
    jm = SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)
    tm = SimpleNamespace(shape=tuple(shape), mesh_dim_names=names)
    return jctx.make_context(jm, **kw), tctx.make_context(tm, **kw)


def models(arch, shape, knobs):
    """(reference model, port model or a stand-in with the reference's
    knob attributes, both on ``shape``'s mesh)."""
    jd, td = contexts(shape)
    jm = jax_build(get_smoke(arch), jd)
    for k, v in knobs.items():
        setattr(jm, k, v)
    cfg = port_smoke(arch)
    if type(build_model(cfg)) is DecoderLM:
        tm = build_model(cfg, td)
        for k, v in knobs.items():
            setattr(tm, k, v)
        for attr in ("shard_heads", "moe_ep"):
            assert getattr(tm, attr) == getattr(jm, attr), attr
        assert tm.full_ep_available() == jm.full_ep_available()
    else:   # RWKVLM, JambaLM, WhisperLM: not on a mesh in the port yet
        tm = SimpleNamespace(cfg=cfg, dist=td, **{
            a: getattr(jm, a) for a in KNOB_ATTRS if hasattr(jm, a)})
    return jm, tm


def flat_specs(specs, prefix=""):
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(flat_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def jax_flat(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, P))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in leaves}


def serving_knobs(arch):
    return optimized_overrides(arch, "decode_32k")


@pytest.mark.parametrize("knobs", ["default", "serving"])
@pytest.mark.parametrize("shape", MESHES, ids=["2x4", "1x4", "4x1"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rule_table_matches_reference(arch, shape, knobs):
    kn = serving_knobs(arch) if knobs == "serving" else {}
    jm, tm = models(arch, shape, kn)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = jax_flat(jS.param_specs(jm, shapes))
    tree = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [str(getattr(k, "key", k)) for k in path]
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    got = flat_specs(tS.param_specs(tm, tree))
    assert got == want
    if arch == "deepseek-v3-671b" and shape == (2, 4) and knobs == "serving":
        assert want["layers/ffn/gate"] == (None, ("data", "model"), None,
                                           None)


@pytest.mark.parametrize("knobs", [{}, {"moe_full_ep": True},
                                   {"no_fsdp_experts": True}],
                         ids=["default", "full_ep", "no_fsdp"])
@pytest.mark.parametrize("shape", MESHES, ids=["2x4", "1x4", "4x1"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_moe_param_specs_match_reference(arch, shape, knobs):
    jm, tm = models(arch, shape, knobs)
    for stacked in (False, True):
        got = flat_specs(tm.moe_param_specs(stacked))
        assert got == jax_flat(jm.moe_param_specs(stacked))


@pytest.mark.parametrize("kv_seq", [None, ("data", "model")])
@pytest.mark.parametrize("shard_batch", [True, False])
def test_cache_and_batch_specs_match_reference(shard_batch, kv_seq):
    jd, td = contexts((2, 4), shard_batch=shard_batch, kv_seq=kv_seq)
    for arch in ("mistral-nemo-12b", "deepseek-v3-671b"):
        jm = jax_build(get_smoke(arch), jd)
        tm = DecoderLM(port_smoke(arch), td)
        assert flat_specs(tm.cache_specs()) == jax_flat(jm.cache_specs())
    jw = JWhisper(get_smoke("whisper-tiny"), jd)
    tw = WhisperLM(port_smoke("whisper-tiny"), td)
    assert flat_specs(tw.cache_specs()) == jax_flat(jw.cache_specs())
    batch = {"tokens": SimpleNamespace(shape=(8, 16)),
             "patch_embeds": SimpleNamespace(shape=(8, 4, 64))}
    for sb in (True, False):
        assert flat_specs(tS.batch_specs(td, batch, sb)) == jax_flat(
            jS.batch_specs(jd, batch, sb))


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model"), ("model",),
                                   ("replica", "x")])
def test_make_context_matches_reference(names):
    shape = tuple(range(2, 2 + len(names)))
    for shard_batch, kv_seq in itertools.product(
            (True, False), (None, (names[-1],))):
        jd, td = contexts(shape, names, shard_batch=shard_batch,
                          kv_seq=kv_seq)
        for attr in ("dp", "tp", "kv_seq", "tp_size", "dp_size"):
            assert getattr(td, attr) == getattr(jd, attr), attr
        assert td.batch_axes() == jd.batch_axes()
        assert td.kv_axes() == jd.kv_axes()
        assert td.active
    assert not tctx.make_context(None).active
    assert tctx.NULL_CTX.tp_size == 1 and tctx.NULL_CTX.dp_size == 1
    x = torch.ones(2)
    assert tctx.NULL_CTX.wsc(x, None) is x


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_optimized_overrides_match_reference(shape_name):
    for arch in ARCH_IDS:
        assert optimized_overrides(arch, shape_name) == j_overrides(
            arch, shape_name)


def test_shard_params_cuts_blocks_that_tile_the_whole():
    """Every rank's blocks of a leaf, placed by its coordinates, give the
    full leaf back: `model` cuts, ("data", "model") cuts in flattened
    order, `data` alone (FSDP) and None leave the dim whole and the leaf
    uncopied."""
    sizes = {"data": 2, "model": 3}
    full = {"a": torch.arange(2 * 6 * 12.).reshape(2, 6, 12),
            "b": torch.arange(4 * 6.).reshape(4, 6),
            "c": torch.arange(5.)}
    specs = {"a": (None, ("data", "model"), "model"), "b": ("data", None),
             "c": (None,)}
    for di, mi in itertools.product(range(2), range(3)):
        def axis_index(axes, di=di, mi=mi):
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + {"data": di, "model": mi}[a]
            return idx

        comm = SimpleNamespace(
            axis_size=lambda axes: int(np.prod(
                [sizes[a] for a in ((axes,) if isinstance(axes, str)
                                    else axes)])),
            axis_index=axis_index)
        local = tS.shard_params(full, specs, SimpleNamespace(comm=comm))
        assert local["b"] is full["b"] and local["c"] is full["c"]
        assert local["a"].shape == (2, 1, 4) and local["a"].is_contiguous()
        # dim 1 is cut over (data, model): rank (di, mi) holds row
        # di * 3 + mi; dim 2 over model: columns [4 mi, 4 mi + 4)
        f = di * 3 + mi
        assert torch.equal(local["a"],
                           full["a"][:, f:f + 1, 4 * mi:4 * mi + 4])
    with pytest.raises(ValueError, match="divide"):
        tS.shard_params({"d": torch.zeros(5, 4)}, {"d": ("model", None)},
                        SimpleNamespace(comm=comm))


def _fake_comm(sizes, coords):
    """axis_size and axis_index over ``sizes`` at the rank ``coords``."""
    def names(axes):
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def axis_index(axes):
        idx = 0
        for a in names(axes):
            idx = idx * sizes[a] + coords[a]
        return idx

    return SimpleNamespace(
        names=tuple(sizes),
        axis_size=lambda axes: int(np.prod([sizes[a] for a in names(axes)])),
        axis_index=axis_index)


def test_shard_params_for_training_cuts_data_dims():
    """With ``train`` the `data` dims are cut too (FSDP), each rank's
    blocks tiling the leaf; ``leaf_axes`` names each leaf's cutting axes
    in mesh order."""
    sizes = {"data": 2, "model": 3}
    full = {"a": torch.arange(2 * 6 * 12.).reshape(2, 6, 12),
            "b": torch.arange(4 * 6.).reshape(4, 6),
            "w": {"c": torch.arange(6 * 4.).reshape(6, 4)}}
    specs = {"a": (None, "data", "model"), "b": ("data", None),
             "w": {"c": ("model", "data")}}
    assert tS.leaf_axes(specs, ("data", "model")) == {
        "a": ("data", "model"), "b": ("data",),
        "w": {"c": ("data", "model")}}
    blocks = {}
    for di, mi in itertools.product(range(2), range(3)):
        comm = _fake_comm(sizes, {"data": di, "model": mi})
        local = tS.shard_params(full, specs, SimpleNamespace(comm=comm),
                                train=True)
        assert local["a"].shape == (2, 3, 4)
        assert local["b"].shape == (2, 6)
        assert local["w"]["c"].shape == (2, 2)
        assert torch.equal(local["a"],
                           full["a"][:, 3 * di:3 * di + 3, 4 * mi:4 * mi + 4])
        blocks[(di, mi)] = local
    # every rank's blocks, placed by its coordinates, tile each leaf
    rows = [torch.cat([blocks[(di, mi)]["a"] for mi in range(3)], dim=2)
            for di in range(2)]
    assert torch.equal(torch.cat(rows, dim=1), full["a"])
    assert torch.equal(torch.cat([blocks[(di, 0)]["b"] for di in range(2)]),
                       full["b"])
    c = torch.cat([torch.cat([blocks[(di, mi)]["w"]["c"] for di in range(2)],
                             dim=1) for mi in range(3)])
    assert torch.equal(c, full["w"]["c"])


def test_microbatch_rows_take_the_reference_rows():
    """Data rank d's microbatch i holds global rows i·B/M + d·B/(M·dp)
    onwards (the reference reshapes the global batch to (M, B/M) and
    splits the second dim over `data`)."""
    from repro_torch.training.step import microbatch_rows
    batch = {"tokens": torch.arange(8)[:, None].repeat(1, 3)}
    for d in range(2):
        dist = SimpleNamespace(active=True, dp_size=2, dp=("data",),
                               comm=_fake_comm({"data": 2}, {"data": d}))
        mbs = microbatch_rows(batch, 2, dist)
        assert [mb["tokens"][:, 0].tolist() for mb in mbs] == [
            [2 * d, 2 * d + 1], [4 + 2 * d, 4 + 2 * d + 1]]
    one = microbatch_rows(batch, 4, tctx.NULL_CTX)
    assert [mb["tokens"][:, 0].tolist() for mb in one] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="microbatches"):
        microbatch_rows(batch, 3, tctx.NULL_CTX)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "deepseek-v3-671b"])
def test_train_state_specs_shard_moments_as_params(arch):
    """``train_state_specs``: the rule table's specs for the params, the
    same for each moment, the step whole; quantized moments raise on a
    mesh."""
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.training.step import train_state_specs
    _, td = contexts((2, 4))
    model = build_model(port_smoke(arch), td)
    shapes = model.init(None, "meta")
    pspecs, ospecs = train_state_specs(model, shapes)
    assert pspecs == tS.param_specs(model, shapes)
    assert ospecs == {"m": pspecs, "v": pspecs, "step": ()}
    assert model.layout()[0] == pspecs
    opt = AdamW(lambda s: 0.0, AdamWConfig(quantized=True))
    small = {"w": torch.zeros(4, 256)}
    with pytest.raises(NotImplementedError, match="item 12, point 7"):
        train_state_specs(model, shapes, opt.init(small))
