"""The PyTorch port's serving path: the torch ServeEngine over
repro_torch.core leases and the JAX ServeEngine over repro.core leases,
given the same requests and the same (bridged) weights, produce identical
greedy tokens; plus the reference serving tests' residency, crash and
straggler checks on the port's stack."""
from __future__ import annotations

import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.core.executor import _holds_cuda_tensor  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402
from repro_torch.serving import ModelServer, ServeEngine  # noqa: E402
from repro_torch.serving.engine import backup_submit  # noqa: E402

ARCH = "mistral-nemo-12b"


def jax_params(dtype="float32", arch=ARCH):
    model = jax_build(get_smoke(arch).replace(dtype=dtype))
    return model, model.init(jax.random.PRNGKey(0))


def stack(core, server, *, workers=1, **kw):
    """Leases ``workers`` worker(s) for ``server`` on a 2-node cluster of
    the given core package (repro.core or repro_torch.core)."""
    ledger = core.Ledger()
    rm = core.ResourceManager(n_replicas=2)
    bs = core.BatchSystem(rm, ledger, n_nodes=2, workers_per_node=2,
                          hot_period=5.0, **kw)
    bs.release_idle()
    inv = core.Invoker("serve", rm, server.make_library(), seed=0)
    inv.allocate(workers)
    return inv, ledger


def torch_stack(arch=ARCH, **kw):
    jm, jp = jax_params(arch=arch)
    model = torch_build(torch_smoke(arch).replace(dtype="float32"))
    params = params_from_flat({k: np.asarray(v) for k, v in _flatten(jp)})
    server = ModelServer(model, params, max_len=48)
    inv, ledger = stack(tcore, server, **kw)
    return jm.cfg, server, inv, ledger


def requests(cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=int(rng.integers(3, 9)))
            for _ in range(n)]


@pytest.mark.parametrize("arch", [ARCH, "rwkv6-1.6b",
                                  "jamba-1.5-large-398b"])
def test_greedy_tokens_identical_to_reference_engine(arch):
    """Left-padded waves of prompts of 3-8 tokens: the pad tokens (0) run
    through attention and through the RWKV and Mamba recurrences alike in
    both."""
    jm, jp = jax_params(arch=arch)
    jserver = jserving.ModelServer(jm, jp, max_len=32)
    jinv, _ = stack(jcore, jserver)
    tm = torch_build(torch_smoke(arch).replace(dtype="float32"))
    tserver = ModelServer(tm, params_from_flat(
        {k: np.asarray(v) for k, v in _flatten(jp)}), max_len=32)
    tinv, _ = stack(tcore, tserver)
    prompts = requests(jm.cfg)
    outs = []
    for engine in (jserving.ServeEngine(jinv, batch_size=2),
                   ServeEngine(tinv, batch_size=2)):
        reqs = [engine.enqueue(p, max_new_tokens=5) for p in prompts]
        engine.run()
        outs.append([r.tokens_out for r in reqs])
    jinv.deallocate()
    tinv.deallocate()
    assert all(len(t) == 5 for t in outs[1])
    assert outs[1] == outs[0]


def test_batched_generation_completes():
    cfg, server, inv, ledger = torch_stack()
    engine = ServeEngine(inv, batch_size=3)
    rng = np.random.default_rng(0)
    for _ in range(7):
        engine.enqueue(rng.integers(1, cfg.vocab_size, size=5),
                       max_new_tokens=4)
    done = engine.run()
    assert len(done) == 7
    for r in done:
        assert len(r.tokens_out) == 4
        assert r.latency is not None and r.latency > 0
        assert r.ttft is not None and r.ttft <= r.latency
    m = engine.metrics()
    assert m["tokens"] == 28 and m["throughput_tok_s"] > 0
    assert ledger.bill("serve").invocations > 0
    inv.deallocate()


def test_session_residency_is_server_side():
    """The KV cache never travels: the decode payload is (sid, token)."""
    cfg, server, inv, _ = torch_stack()
    out = inv.invoke("prefill", {"tokens": np.ones((2, 4), np.int32)})
    sid = out["sid"]
    assert sid in server._sessions
    cache, length = server._sessions[sid]
    assert cache["k"].shape[2] == 48 and length == 4
    f = inv.submit("decode",
                   {"sid": sid, "tokens": out["next_token"][:, None]})
    res = f.get()
    assert f.invocation.bytes_in < 1024
    assert isinstance(res["next_token"], np.ndarray)
    assert res["next_token"].shape == (2,)
    assert server._sessions[sid][0]["k"] is cache["k"]    # updated in place
    inv.invoke("close_session", {"sid": sid})
    assert sid not in server._sessions
    inv.deallocate()


def test_rwkv_session_state_is_resident_and_updated_in_place():
    """For RWKV the session holds the O(1) recurrent state; max_len does
    not size it, and decode writes it in place."""
    cfg, server, inv, _ = torch_stack("rwkv6-1.6b")
    out = inv.invoke("prefill", {"tokens": np.ones((2, 5), np.int32)})
    sid = out["sid"]
    state, length = server._sessions[sid]
    hd = cfg.rwkv.head_dim
    assert length == 5
    assert state["wkv"].shape == (cfg.n_layers, 2, cfg.d_model // hd, hd,
                                  hd)
    before = state["wkv"].clone()
    res = inv.submit("decode", {"sid": sid,
                                "tokens": out["next_token"][:, None]}).get()
    assert res["next_token"].shape == (2,)
    assert server._sessions[sid][0]["wkv"] is state["wkv"]
    assert server._sessions[sid][1] == 6
    assert not torch.equal(state["wkv"], before)
    inv.invoke("close_session", {"sid": sid})
    inv.deallocate()


def test_jamba_session_cache_is_resident_and_updated_in_place():
    """For Jamba the session holds the attention cache and the Mamba
    states as one tree; the engine never looks inside it, and decode
    writes every part in place."""
    cfg, server, inv, _ = torch_stack("jamba-1.5-large-398b")
    out = inv.invoke("prefill", {"tokens": np.ones((2, 5), np.int32)})
    sid = out["sid"]
    cache, length = server._sessions[sid]
    P = cfg.n_layers // cfg.attn_layer_period
    nm = cfg.attn_layer_period - 1
    di = cfg.mamba.expand * cfg.d_model
    assert length == 5
    assert cache["attn"]["k"].shape[:3] == (P, 2, 48)
    assert cache["mamba"]["ssm"].shape == (P, nm, 2, di, cfg.mamba.d_state)
    before = cache["mamba"]["ssm"].clone()
    res = inv.submit("decode", {"sid": sid,
                                "tokens": out["next_token"][:, None]}).get()
    assert res["next_token"].shape == (2,)
    after, length = server._sessions[sid]
    assert length == 6
    for path in (("attn", "k"), ("mamba", "ssm"), ("mamba", "conv")):
        assert after[path[0]][path[1]] is cache[path[0]][path[1]]
    assert not torch.equal(cache["mamba"]["ssm"], before)
    assert cache["attn"]["k"][:, :, 5].abs().sum() > 0
    inv.invoke("close_session", {"sid": sid})
    inv.deallocate()


def test_serving_survives_worker_crash():
    cfg, server, inv, _ = torch_stack(fault_rate=0.0)
    engine = ServeEngine(inv, batch_size=2)
    rng = np.random.default_rng(1)
    for _ in range(3):
        engine.enqueue(rng.integers(1, cfg.vocab_size, size=4),
                       max_new_tokens=3)
    inv.allocate(1)            # a second worker for the retry
    inv.connections()[0].process.workers[0].crash()
    done = engine.run()
    assert len(done) == 3 and all(len(r.tokens_out) == 3 for r in done)
    inv.deallocate()


def test_backup_submit_straggler():
    calls = {"n": 0}

    def maybe_slow(x):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.2)                     # straggler
        return x * 2

    lib = tcore.FunctionLibrary("slow")
    lib.register("f", maybe_slow)
    ledger = tcore.Ledger()
    rm = tcore.ResourceManager(n_replicas=1)
    bs = tcore.BatchSystem(rm, ledger, n_nodes=1, workers_per_node=2)
    bs.release_idle()
    inv = tcore.Invoker("c", rm, lib, seed=0)
    inv.allocate(2)
    out, used_backup = backup_submit(inv, "f", np.ones(4, np.float32), 0.02)
    assert (out == 2.0).all() and used_backup
    inv.deallocate()


def test_executor_waits_only_on_card_results():
    assert not _holds_cuda_tensor({"a": [torch.ones(2), np.ones(2)]}, torch)
    assert not _holds_cuda_tensor(3, torch)
    meta = torch.empty(2, device="meta")
    assert not _holds_cuda_tensor((meta,), torch)
