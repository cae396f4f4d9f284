"""rwkv6-1.6b's gradients through K2's two backward routes, in bf16 and f32.

One batch (numpy seed 7, 4 x 2048 tokens) through ``RWKVLM.loss`` at
full width and each depth of ``--layers``, params from seed 0, with
every K2 backward on the "general" route (``kernel_bwd.plan`` replaced
for the run) or on the route ``plan`` picks ("hopper" at hd 64).  Prints
each run's loss, gradient norm and K2 backward launches by route, then
the global and worst-leaf relative differences between the two routes
(bf16 and f32) and between bf16 and f32.  The two routes sum in other
orders, so they agree to f32 rounding in f32; in bf16 they differ by as
much as bf16 rounding, amplified through the layers, lets them.  Needs
the card:

    python3 experiments/rwkv6_grad_routes_torch.py --layers 2 24
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel_bwd, ops  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.training.step import value_and_grad  # noqa: E402


def grads(cfg, route, batch):
    """(loss, leaves on the CPU in f32, leaf names, launches by route)."""
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    plan = kernel_bwd.plan
    if route == "general":
        kernel_bwd.plan = lambda *a: "general"
    before = dict(ops.launches_bwd_by_route)
    try:
        loss, _, g = value_and_grad(model, params, batch)
    finally:
        kernel_bwd.plan = plan
    took = {k: n - before[k] for k, n in ops.launches_bwd_by_route.items()}
    leaves = [x.float().cpu() for x in T.leaves(g)]
    names = [path for path, _ in T.flatten(g)]
    del params, model, g
    torch.cuda.empty_cache()
    return loss.item(), leaves, names, took


def compare(a, b, what):
    (_, la, names, _), (_, lb, _, _) = a, b
    rel = [((x - y).norm() / y.norm().clamp_min(1e-30)).item()
           for x, y in zip(la, lb)]
    worst = sorted(zip(rel, names), reverse=True)[:3]
    total = (torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(la, lb)))
             / torch.sqrt(sum((y * y).sum() for y in lb))).item()
    print(f"  {what}: global rel diff {total:.3e}; worst leaves "
          + ", ".join(f"{name} {r:.2e}" for r, name in worst))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 24])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0))
    for n_layers in args.layers:
        base = get_config("rwkv6-1.6b").replace(n_layers=n_layers)
        rng = np.random.default_rng(7)
        toks = torch.from_numpy(
            rng.integers(0, base.vocab_size, (4, 2049))).cuda()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        runs = {}
        for dtype in ("bfloat16", "float32"):
            for route in ("general", "hopper"):
                runs[dtype, route] = grads(base.replace(dtype=dtype), route,
                                           batch)
                loss, leaves, _, took = runs[dtype, route]
                norm = torch.sqrt(sum((x * x).sum() for x in leaves)).item()
                print(f"{n_layers} layers, {dtype}, {route}: loss "
                      f"{loss:.6f}, gradient norm {norm:.4f}, K2 backward "
                      f"launches by route {took}")
        for dtype in ("bfloat16", "float32"):
            compare(runs[dtype, "hopper"], runs[dtype, "general"],
                    f"{dtype}: hopper against general")
        for route in ("general", "hopper"):
            compare(runs["bfloat16", route], runs["float32", route],
                    f"{route}: bf16 against f32")
    return 0


if __name__ == "__main__":
    sys.exit(main())
