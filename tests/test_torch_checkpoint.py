"""The port's checkpoints against the reference's on-disk format: a
checkpoint written by either package restores bit for bit in the other
(bf16 params, f32 and int8-quantized AdamW moments, the step), with the
same manifest; the bridge's reverse direction; and a run of the port's
launcher restored from its own checkpoint continuing bit for bit."""
from __future__ import annotations

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing import restore as jax_restore  # noqa: E402
from repro.checkpointing import save as jax_save  # noqa: E402
from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.bridge import (flat_from_params,  # noqa: E402
                                opt_state_from_flat, params_from_flat)
from repro_torch.checkpointing import (AsyncCheckpointer,  # noqa: E402
                                       latest_step, restore, save)
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.launch import train as torch_train  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402
from repro_torch.optim import quant  # noqa: E402


def jax_state(quantized):
    """The reference's bf16 minicpm smoke params and an AdamW state after
    one update, as a checkpoint tree."""
    jm = jax_build(get_smoke("minicpm-2b"))
    params = jm.init(jax.random.PRNGKey(0))
    opt = JAdamW(lambda s: 1e-3 * s, JAdamWConfig(quantized=quantized))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, state, _ = opt.update(grads, opt.init(params), params)
    return {"params": params, "opt": state}


def jax_flat(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree)}


def port_state(jtree):
    params = params_from_flat(jax_flat(jtree["params"]))
    opt = opt_state_from_flat(jax_flat(jtree["opt"]), params)
    return {"params": params, "opt": opt}


def assert_same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("quantized", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, quantized):
    jtree = jax_state(quantized)
    tree = port_state(jtree)
    save(str(tmp_path / "port"), 7, tree)
    jax_save(str(tmp_path / "ref"), 7, jtree)
    manifests = [json.load(open(tmp_path / d / "step-00000007" /
                                "manifest.json")) for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    template = jax.eval_shape(lambda: jtree)
    got = jax_restore(str(tmp_path / "port"), 7, template)
    want = jax_flat(jtree)
    for key, leaf in _flatten(got):
        assert_same_bits(leaf, want[key])


@pytest.mark.parametrize("quantized", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, quantized):
    jtree = jax_state(quantized)
    jax_save(str(tmp_path), 3, jtree)
    template = port_state(jtree)
    got = restore(str(tmp_path), 3, template)
    if quantized:
        moment = got["opt"]["m"]["embed"]["tokens"]
        assert isinstance(moment, quant.QTensor)
        assert moment.shape == template["opt"]["m"]["embed"]["tokens"].shape
    assert got["params"]["embed"]["tokens"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32
    want = jax_flat(jtree)
    got_flat = flat_from_params(got)
    assert set(got_flat) == set(want)
    for key, arr in got_flat.items():
        assert_same_bits(arr, want[key])


def test_restore_onto_a_meta_template_and_key_mismatch(tmp_path):
    tree = {"w": torch.randn(3, 4).to(torch.bfloat16),
            "s": torch.tensor(5, dtype=torch.int32)}
    save(str(tmp_path), 1, tree)
    meta = T.map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), tree)
    got = restore(str(tmp_path), 1, meta)
    assert got["w"].device.type == "cpu"
    assert torch.equal(got["w"].view(torch.int16), tree["w"].view(torch.int16))
    with pytest.raises(ValueError, match="key mismatch"):
        restore(str(tmp_path), 1, {"w": tree["w"]})


def test_bridge_reverse_direction_is_bit_exact():
    """params and quantized AdamW state, reference -> port -> reference."""
    jtree = jax_state(True)
    for part in ("params", "opt"):
        want = jax_flat(jtree[part])
        got = flat_from_params(port_state(jtree)[part])
        assert set(got) == set(want)
        for key in want:
            assert_same_bits(got[key], want[key])
    assert got["m/embed/tokens/0"].dtype == np.int8


def test_async_checkpointer_commits_and_keeps_the_newest(tmp_path):
    opt = AdamW(lambda s: torch.tensor(1e-3), AdamWConfig(quantized=True))
    params = {"w": torch.randn(4, 300), "b": torch.randn(3)}
    state = {"params": params, "opt": opt.init(params)}
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (2, 4, 6):
        ck.save(step, state)
    ck.wait()
    assert latest_step(str(tmp_path)) == 6
    assert sorted(os.listdir(tmp_path)) == ["step-00000004", "step-00000006"]
    got = restore(str(tmp_path), 6, state)
    assert torch.equal(got["params"]["w"], params["w"])
    assert torch.equal(got["opt"]["v"]["w"].q, state["opt"]["v"]["w"].q)


def test_async_checkpointer_saves_the_state_of_its_call(tmp_path,
                                                         monkeypatch):
    """An async save of CPU state, then one in-place AdamW update before
    the background write starts: the checkpoint holds the bits of the
    save's call (bf16 and f32 params, f32 moments, the step), not the
    update's."""
    from repro_torch.checkpointing import checkpoint as ckpt_mod
    gate = threading.Event()
    real_write = ckpt_mod._write

    def gated_write(*a):
        gate.wait()
        return real_write(*a)

    monkeypatch.setattr(ckpt_mod, "_write", gated_write)
    opt = AdamW(lambda s: torch.tensor(1e-2), AdamWConfig())
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 300, generator=gen).to(torch.bfloat16),
              "b": torch.randn(3, generator=gen)}
    state = {"params": params, "opt": opt.init(params)}
    grads = T.map_tree(lambda p: torch.ones_like(p), params)
    state["params"], state["opt"], _ = opt.update(grads, state["opt"],
                                                  params)
    saved = T.map_tree(lambda t: t.clone(), state)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, state)
    opt.update(grads, state["opt"], state["params"])   # in place
    assert not torch.equal(state["params"]["b"], saved["params"]["b"])
    gate.set()
    ck.wait()
    got = restore(str(tmp_path), 1, saved)
    def bits(t):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()

    for g, w in zip(T.leaves(got), T.leaves(saved)):
        assert_same_bits(bits(g), bits(w))


def test_launcher_resumes_bit_for_bit(tmp_path):
    """The launcher on the CPU: 6 steps straight, and 4 steps with a
    checkpoint at step 4, then a resumed run to step 6; the resumed
    steps' losses are those of the straight run, bit for bit."""
    cfg = torch_smoke("minicpm-2b")
    kw = dict(batch=2, seq=16, device="cpu", log=lambda *a: None)
    straight = torch_train.run(cfg, steps=6, **kw)["records"]
    ckpt = str(tmp_path / "ckpt")
    first = torch_train.run(cfg, steps=4, ckpt_dir=ckpt, ckpt_every=4,
                            **kw)["records"]
    assert latest_step(ckpt) == 4
    second = torch_train.run(cfg, steps=6, ckpt_dir=ckpt, resume=True,
                             **kw)["records"]
    assert [r["step"] for r in second] == [5, 6]
    assert [r["loss"] for r in first + second] == [
        r["loss"] for r in straight]
