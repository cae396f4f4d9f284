"""The ranks of the port's mesh tests (``tests/test_torch_mesh.py`` and
``tests/test_torch_mesh_train.py`` on the CPU, ``tests/test_torch_gpu.py``
on the card).  ``spawn`` runs one process a rank:

    python tests/torch_mesh_ranks.py RANK SHAPE AXES STORE INPUTS OUTPUT \
        DEVICE BACKEND

which joins a mesh of SHAPE ("2x2") with dims AXES ("data,model") of
BACKEND ranks over DEVICE through the ``FileStore`` at STORE, runs every
case of INPUTS (a ``torch.save``'d dict written by the test, with full
weights and inputs) on this rank's shards, and ``torch.save``s this
rank's outputs to OUTPUT.  Serving cases run under
``torch.inference_mode``, training cases (``TRAINING``) with autograd.
It imports torch and the port only, never JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
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
from repro_torch import tree as T
from repro_torch.distribution import sharding as S
from repro_torch.distribution.sharding import param_specs, shard_params
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import attention as A
from repro_torch.models.factory import build_model
from repro_torch.optim import AdamW, AdamWConfig, cosine, quant
from repro_torch.training import step as train_step
from repro_torch.training.pipeline import gpipe_forward


def rows(t, ctx):
    """This rank's rows of a batch split over `data`."""
    n = t.shape[0] // ctx.dp_size
    return t[ctx.comm.axis_index(ctx.dp) * n:][:n]


def slots(t, ctx):
    """This rank's slots of a cache (b, S, ...) split over kv_seq."""
    n = t.shape[1] // ctx.comm.axis_size(ctx.kv_seq)
    return t[:, ctx.comm.axis_index(ctx.kv_seq) * n:][:, :n]


def model_for(case, ctx):
    cfg = get_smoke(case["arch"]).replace(dtype=case["dtype"],
                                          **case.get("replace", {}))
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


# Faults of the training cases, on every rank: "no-enter" (``comm.enter``
# the identity backward too: a replicated value's gradient left partial
# over `model`), "no-data-sum" (a leaf no `data` dim cuts keeps its rank's
# part of the gradient)
FAULTS = ("no-enter", "no-data-sum")


class _NoEnter:
    def __init__(self, comm):
        self.comm, self.real = comm, comm.enter

    def __enter__(self):
        self.comm.enter = lambda x, axes: x

    def __exit__(self, *exc):
        self.comm.enter = self.real


class _NoDataSum:
    """The step's sum over `data` of the leaves no `data` dim cuts left
    out (every rank alike, so no collective is left waiting)."""

    def __enter__(self):
        self.real = train_step._MeshLayout.reduce
        train_step._MeshLayout.reduce = lambda self, grads, params, whole: \
            grads

    def __exit__(self, *exc):
        train_step._MeshLayout.reduce = self.real


class _Capture:
    """An optimizer that keeps the step's gradients and updates nothing."""

    def update(self, grads, state, params, mesh=None):
        self.grads = grads
        return params, state, {}


def whole(tree, specs, ctx):
    """``shard_params(..., train=True)``'s inverse: every cut dim of each
    leaf all-gathered back over its axes, the full leaves on every rank."""
    def gather(t, spec):
        for dim, entry in enumerate(spec):
            axes = S.cut_axes(entry, train=True)
            if axes:
                t = ctx.comm.all_gather(t.detach(), axes, dim=dim)
        return t

    return T.map_tree(gather, tree, specs)


def run_train_loss(case, ctx):
    """One microbatch through make_train_step with grad_specs on the
    global batch: loss, xent and every gradient leaf, summed over `data`
    and gathered whole (keys "loss", "xent", "g/<path>")."""
    model = model_for(case, ctx)
    specs, _ = model.layout()
    params = shard_params(case["params"], specs, ctx, train=True)
    capture = _Capture()
    step = train_step.make_train_step(model, capture, grad_specs=specs)
    with contextlib.ExitStack() as stack:
        if case.get("fault") == "no-enter":
            stack.enter_context(_NoEnter(ctx.comm))
        if case.get("fault") == "no-data-sum":
            stack.enter_context(_NoDataSum())
        metrics = step(params, None, case["batch"])[2]
    out = {"loss": metrics["loss"], "xent": metrics["xent"]}
    for path, g in T.flatten(whole(capture.grads, specs, ctx)):
        out[f"g/{path}"] = g
    return out


def run_train_step(case, ctx):
    """One make_train_step step on the global batch: loss, grad_norm, and
    the updated params and moments gathered whole ("p/", "m/", "v/"), and
    the collectives' bytes by op ("bytes/<op>")."""
    model = model_for(case, ctx)
    specs, _ = model.layout()
    params = shard_params(case["params"], specs, ctx, train=True)
    opt = AdamW(lambda s: cosine(s, peak_lr=case["peak_lr"], warmup=2,
                                 total=10), AdamWConfig())
    state = opt.init(params)
    step = train_step.make_train_step(
        model, opt, microbatches=case["microbatches"],
        grad_specs=specs if case["grad_specs"] else None)
    ctx.comm.reset()
    params, state, metrics = step(params, state, case["batch"])
    out = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"]}
    for key, tree in (("p", params), ("m", state["m"]), ("v", state["v"])):
        for path, t in T.flatten(whole(tree, specs, ctx)):
            out[f"{key}/{path}"] = t
    for op, n in ctx.comm.bytes_by_op.items():
        out[f"bytes/{op}"] = torch.tensor(n)
    return out


def run_gpipe(case, ctx):
    comm = ctx.comm
    s = comm.axis_index(case["axis"])
    mine = {k: v[s:s + 1] for k, v in case["params"].items()}
    return gpipe_forward(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                         mine, case["xs"], comm=comm, axis=case["axis"])


def run_compressed_psum(case, ctx):
    """compress_with_feedback and compressed_psum over `data` on this data
    rank's gradient and error."""
    d = ctx.comm.axis_index("data")
    grad, err = case["grads"][d], case["errors"][d]
    q, new_err = quant.compress_with_feedback(grad, err)
    summed, err2 = quant.compressed_psum(grad, err, ctx.comm, "data")
    return {"q": q.q, "scale": q.scale, "err": new_err, "sum": summed,
            "err2": err2}


RUN = {"sp_decode": run_sp_decode, "mla_sp": run_mla_sp, "moe": run_moe,
       "decoder": run_decoder, "train_loss": run_train_loss,
       "train_step": run_train_step, "gpipe": run_gpipe,
       "compressed_psum": run_compressed_psum}
TRAINING = ("train_loss", "train_step")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _cpu(out):
    if isinstance(out, dict):
        return {k: v.detach().cpu() for k, v in out.items()}
    return out.cpu()


def main(argv):
    rank = int(argv[1])
    shape = tuple(int(n) for n in argv[2].split("x"))
    axes = tuple(argv[3].split(","))
    store_path, inputs, output, device, backend = argv[4:9]
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    world = math.prod(shape)
    store = dist.FileStore(store_path, world)
    mesh = make_smoke_mesh(shape, axes, device_type=device, backend=backend,
                           store=store, rank=rank)
    ctx = make_context(mesh, comm=Collectives(mesh))
    staged = ctx.comm.stage
    cases = torch.load(inputs, weights_only=True)
    out = {}
    for name, case in cases.items():
        # "staged": the collectives' path for gloo over CUDA (operands
        # copied to host memory and back), on the CPU from CPU to CPU
        ctx.comm.stage = case.get("staged", staged)
        mode = (contextlib.nullcontext() if case["kind"] in TRAINING
                else torch.inference_mode())
        with mode:
            out[name] = _cpu(RUN[case["kind"]](_to(case, device), ctx))
    out["coords"] = torch.tensor([ctx.comm.axis_index(a) for a in axes])
    torch.save(out, output)
    dist.barrier()
    dist.destroy_process_group()


def spawn(cases, mesh, tmp, *, device="cpu", backend="gloo", deadline=240,
          axes=("data", "model")):
    """Runs every case on the ranks of ``mesh`` (a shape; dims ``axes``;
    one process a rank, all on card 0 where ``device`` is "cuda");
    returns each rank's outputs keyed by its coordinates.  Raises if a
    rank fails or the ranks outlive ``deadline`` seconds (then every rank
    is stopped)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(cases, tmp / "in.pt")
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    world = math.prod(mesh)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "x".join(map(str, mesh)),
         ",".join(axes), str(tmp / "store"), str(tmp / "in.pt"),
         str(tmp / f"out{r}.pt"), device, backend],
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
    # the first rank that raised (the others then fail with it)
    bad = sorted([(r, p.returncode, logs[r].decode()[-3000:])
                  for r, p in enumerate(procs) if p.returncode != 0],
                 key=lambda b: "Traceback" not in b[2])[:1]
    if bad:
        raise RuntimeError(f"mesh {mesh}: ranks failed: {bad}")
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=True)
            for r in range(world)]
    return {tuple(o["coords"].tolist()): o for o in outs}


class JaxRun:
    """``script`` run by the JAX package in a subprocess with 4 host
    devices (``--xla_force_host_platform_device_count=4``, JAX on the
    CPU), started at once so that it runs beside the ranks: it reads
    ``inputs`` (saved with ``np.savez``) from argv[1] and writes its
    outputs to argv[2].  ``outputs()`` waits for it by ``deadline``
    seconds; ``close()`` stops it.  Only the subprocess imports JAX."""

    def __init__(self, tmp, script, inputs, deadline=240):
        import textwrap

        import numpy as np
        self.tmp, self.deadline, self._out = Path(tmp), deadline, None
        np.savez(self.tmp / "jax_in.npz", **inputs)
        root = Path(__file__).resolve().parents[1]
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=str(root / "src"))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(script),
             str(self.tmp / "jax_in.npz"), str(self.tmp / "jax_out.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=root)

    def outputs(self):
        import numpy as np
        if self._out is None:
            try:
                log = self.proc.communicate(timeout=self.deadline)[0]
            except subprocess.TimeoutExpired:
                self.close()
                raise RuntimeError(f"the JAX mesh run outlived "
                                   f"{self.deadline} s") from None
            if self.proc.returncode != 0:
                raise RuntimeError(log.decode()[-4000:])
            self._out = dict(np.load(self.tmp / "jax_out.npz"))
        return self._out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


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
