"""The ranks of the port's mesh tests (``tests/test_torch_mesh.py`` on the
CPU, ``tests/test_torch_gpu.py`` on the card).  ``spawn`` runs one
process a rank:

    python tests/torch_mesh_ranks.py RANK DATA MODEL STORE INPUTS OUTPUT \
        DEVICE BACKEND

which joins a (DATA, MODEL) ("data", "model") mesh of BACKEND ranks over
DEVICE through the ``FileStore`` at STORE, runs every case of INPUTS (a
``torch.save``'d dict written by the test, with full weights and inputs)
on this rank's shards, and ``torch.save``s this rank's outputs to OUTPUT.
It imports torch and the port only, never JAX.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke
from repro_torch.distribution.collectives import Collectives
from repro_torch.distribution.context import make_context
from repro_torch.distribution.sharding import param_specs, shard_params
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import attention as A
from repro_torch.models.factory import build_model


def rows(t, ctx):
    """This rank's rows of a batch split over `data`."""
    n = t.shape[0] // ctx.dp_size
    return t[ctx.comm.axis_index(ctx.dp) * n:][:n]


def slots(t, ctx):
    """This rank's slots of a cache (b, S, ...) split over kv_seq."""
    n = t.shape[1] // ctx.comm.axis_size(ctx.kv_seq)
    return t[:, ctx.comm.axis_index(ctx.kv_seq) * n:][:, :n]


def model_for(case, ctx):
    cfg = get_smoke(case["arch"]).replace(dtype=case["dtype"])
    if case["moe"]:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **case["moe"]))
    model = build_model(cfg, ctx)
    for knob, value in case["knobs"].items():
        setattr(model, knob, value)
    return model


def sharded(model, params, ctx):
    return shard_params(params, param_specs(model, params), ctx)


def run_sp_decode(case, ctx):
    return A.decode_attention_sp(
        rows(case["q"], ctx), slots(rows(case["k"], ctx), ctx),
        slots(rows(case["v"], ctx), ctx), case["length"], ctx,
        window=case["window"], softcap=case["softcap"])


def run_mla_sp(case, ctx):
    model = model_for(case, ctx)
    ap = sharded(model, case["params"], ctx)["layers"]["attn"]
    ap = {k: v[0] for k, v in ap.items()}
    x = rows(case["x"], ctx)
    positions = torch.full((x.shape[0], 1), case["length"] - 1)
    return A.mla_decode_sp(x, ap, model.cfg,
                           slots(rows(case["ckv"], ctx), ctx),
                           slots(rows(case["krope"], ctx), ctx),
                           case["length"], positions, ctx)


def run_moe(case, ctx):
    model = model_for(case, ctx)
    model.moe_full_ep = case["mode"] == "full_ep"
    model.moe_ep = case["mode"] == "ep"
    mp = sharded(model, {"layers": {"ffn": case["params"]}},
                 ctx)["layers"]["ffn"]
    y, aux = model._moe(rows(case["x"], ctx), mp)
    return torch.cat([y.reshape(-1).float(), aux.reshape(1).float()])


def run_decoder(case, ctx):
    model = model_for(case, ctx)
    params = sharded(model, case["params"], ctx)
    logits, cache, length = model.prefill(params, rows(case["tokens"], ctx),
                                          case["max_len"])
    out = [logits]
    for tok in case["forced"].unbind(1):
        logits, cache, length = model.decode(params, cache,
                                             rows(tok[:, None], ctx), length)
        out.append(logits)
    return torch.cat(out, dim=1)


RUN = {"sp_decode": run_sp_decode, "mla_sp": run_mla_sp, "moe": run_moe,
       "decoder": run_decoder}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def main(argv):
    rank, data, model_size = (int(a) for a in argv[1:4])
    store_path, inputs, output, device, backend = argv[4:9]
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    world = data * model_size
    store = dist.FileStore(store_path, world)
    mesh = make_smoke_mesh((data, model_size), ("data", "model"),
                           device_type=device, backend=backend, store=store,
                           rank=rank)
    ctx = make_context(mesh, comm=Collectives(mesh))
    staged = ctx.comm.stage
    cases = torch.load(inputs, weights_only=True)
    out = {}
    with torch.inference_mode():
        for name, case in cases.items():
            # "staged": the collectives' path for gloo over CUDA (operands
            # copied to host memory and back), on the CPU from CPU to CPU
            ctx.comm.stage = case.get("staged", staged)
            out[name] = RUN[case["kind"]](_to(case, device), ctx).cpu()
    out["coords"] = torch.tensor([ctx.comm.axis_index("data"),
                                  ctx.comm.axis_index("model")])
    torch.save(out, output)
    dist.barrier()
    dist.destroy_process_group()


def spawn(cases, mesh, tmp, *, device="cpu", backend="gloo", deadline=240):
    """Runs every case on the ranks of ``mesh`` (one process each, all on
    card 0 where ``device`` is "cuda"); returns each rank's outputs keyed
    by its (data, model) coordinates.  Raises if a rank fails or the
    ranks outlive ``deadline`` seconds (then every rank is stopped)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(cases, tmp / "in.pt")
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    world = mesh[0] * mesh[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(mesh[0]), str(mesh[1]),
         str(tmp / "store"), str(tmp / "in.pt"), str(tmp / f"out{r}.pt"),
         device, backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    end = time.monotonic() + deadline
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, end - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"mesh {mesh}: ranks still running after "
                           f"{deadline} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r].decode()[-3000:])
           for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"mesh {mesh}: ranks failed: {bad}")
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=True)
            for r in range(world)]
    return {tuple(o["coords"].tolist()): o for o in outs}


def by_rows(outs, name, mesh):
    """A case's per-rank row blocks in batch order (model rank 0 of each
    data rank), after checking that every model rank of a data rank
    holds the same bits."""
    blocks = []
    for di in range(mesh[0]):
        first = outs[(di, 0)][name]
        for mi in range(1, mesh[1]):
            if not torch.equal(outs[(di, mi)][name], first):
                raise AssertionError(f"{name}: ranks ({di}, 0) and "
                                     f"({di}, {mi}) disagree")
        blocks.append(first)
    return torch.cat(blocks).float()


if __name__ == "__main__":
    main(sys.argv)
