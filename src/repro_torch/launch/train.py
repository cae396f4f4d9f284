"""Training launcher: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 30                       # the smoke config, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --full \
        --batch 4 --seq 2048 --steps 6   # minicpm-2b, published, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --full --batch 4 --seq 2048 --steps 6   # rwkv6-1.6b, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch jamba-1.5-large-398b --steps 6   # Jamba's smoke config

Trains ``--arch`` (the smoke config, or with ``--full`` the published
one) from random weights (seed 0) on the deterministic synthetic stream
(seed 1) through the port's AdamW and remat'ed train step, with WSD for
minicpm-2b (its paper's recipe) and cosine otherwise, as the reference.
``run`` takes any config: jamba-1.5-large-398b (398 B params) trains on
one card only as a cut, which its caller builds (``chip_smoke.py``'s
2-layer dense cut), as the reference's launcher has no cut flag either.
It runs on the card unless ``--device`` says otherwise, and never falls
back to the CPU.  Each step prints its loss, lr, gradient norm, time
(host clock, up to the card finishing the step), tokens a second and the
card's peak memory so far.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpointing import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import Prefetcher, SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models.factory import build_model
from repro_torch.optim import AdamW, AdamWConfig, cosine, wsd
from repro_torch.training.step import make_train_step


def schedule_for(cfg, steps):
    if cfg.name == "minicpm-2b":            # WSD per the paper's recipe
        return lambda s: wsd(s, peak_lr=3e-3, warmup=10, stable=steps,
                             decay=steps // 4)
    return lambda s: cosine(s, peak_lr=3e-3, warmup=10, total=steps)


def to_device(batch, device):
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def run(cfg, *, steps, batch, seq, device=None, ckpt_dir=None,
        ckpt_every=20, resume=False, on_step=None, log=print):
    """Trains ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens.
    ``on_step(record)`` runs after each step, once the card has finished
    it.  Returns {"records": per-step dicts, "model", "params",
    "opt_state", "step_fn", "data"}."""
    device = resolve_device(device)
    model = build_model(cfg)
    opt = AdamW(schedule_for(cfg, steps), AdamWConfig(weight_decay=0.01))
    step_fn = make_train_step(model, opt)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    opt_state = opt.init(params)
    start = 0
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt and resume and (last := latest_step(ckpt_dir)):
        state = restore(ckpt_dir, last, {"params": params, "opt": opt_state})
        params, opt_state, start = state["params"], state["opt"], last
        log(f"resumed from step {last}")

    data = SyntheticLMDataset(cfg.vocab_size, seq, batch, seed=1)
    pf = Prefetcher(data, start_step=start)
    records = []
    try:
        for _ in range(start, steps):
            step, host_batch = pf.next()
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state,
                                           to_device(host_batch, device))
            loss = float(m["loss"])                # waits for the card
            dt = time.perf_counter() - t0
            rec = {"step": step + 1, "loss": loss, "lr": float(m["lr"]),
                   "grad_norm": float(m["grad_norm"]), "step_ms": dt * 1e3,
                   "tok_s": batch * seq / dt,
                   "max_memory_gb": (torch.cuda.max_memory_allocated(device)
                                     / 1e9 if device.type == "cuda"
                                     else None)}
            records.append(rec)
            mem = ("" if rec["max_memory_gb"] is None
                   else f" max_mem={rec['max_memory_gb']:.2f}GB")
            log(f"step {rec['step']:5d} loss={loss:.4f} lr={rec['lr']:.2e} "
                f"gnorm={rec['grad_norm']:.3f} {rec['step_ms']:.1f}ms "
                f"{rec['tok_s']:.0f}tok/s{mem}")
            if on_step is not None:
                on_step(rec)
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
    finally:
        pf.stop()
        if ckpt:
            ckpt.wait()
    return {"records": records, "model": model, "params": params,
            "opt_state": opt_state, "step_fn": step_fn, "data": data}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    t0 = time.time()
    out = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              device=args.device, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, resume=args.resume)
    losses = [r["loss"] for r in out["records"]]
    dt = time.time() - t0
    if losses:
        print(f"{len(losses)} steps in {dt:.1f}s; loss "
              f"{np.mean(losses[:5]):.4f} -> {np.mean(losses[-5:]):.4f}")


if __name__ == "__main__":
    main()
