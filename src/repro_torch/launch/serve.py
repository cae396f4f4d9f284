"""Serving launcher: hosts a model behind the rFaaS stack and drives a
synthetic request stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --requests 16

Runs the reduced (smoke) config of ``--arch`` with random weights drawn
from a seeded generator on ``--device``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import BatchSystem, Invoker, Ledger, ResourceManager
from repro_torch.device import resolve_device
from repro_torch.models.factory import build_model
from repro_torch.serving import ModelServer, ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--churn", action="store_true",
                    help="run batch-system churn during serving")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    server = ModelServer(model, params, max_len=args.max_len)
    lib = server.make_library()

    ledger = Ledger()
    rm = ResourceManager(n_replicas=2)
    cluster = BatchSystem(rm, ledger, n_nodes=args.nodes,
                          workers_per_node=2, hot_period=10.0)
    cluster.release_idle()
    rm.start_heartbeats()
    invoker = Invoker("serve", rm, lib, seed=0)
    granted = invoker.allocate(1)
    print(f"leased {granted} worker(s) on "
          f"{len(rm.primary().server_list())} available nodes")

    engine = ServeEngine(invoker, batch_size=args.batch)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        engine.enqueue(rng.integers(1, cfg.vocab_size,
                                    size=int(rng.integers(4, 12))),
                       max_new_tokens=args.new_tokens)
        if args.churn:
            cluster.churn_step(p_claim=0.1, p_release=0.3)
            if invoker.n_workers == 0:
                invoker.allocate(1)
    engine.run()
    m = engine.metrics()
    print(f"served {m['requests']} requests / {m['tokens']} tokens on "
          f"{device} | {m['throughput_tok_s']:.1f} tok/s | "
          f"p50 {m['p50_latency_s']*1e3:.0f} ms  "
          f"p99 {m['p99_latency_s']*1e3:.0f} ms  "
          f"ttft {m['p50_ttft_s']*1e3:.0f} ms")
    invoker.deallocate()
    rm.stop()
    bill = ledger.bill("serve")
    print(f"bill: {bill.invocations} invocations, "
          f"{bill.compute_seconds:.2f} s compute, "
          f"${ledger.cost('serve'):.8f}")


if __name__ == "__main__":
    main()
