"""Times a decoder's decode step on the card and counts its kernel
launches, for the PyTorch port.

    PYTHONPATH=src python examples/profile_decode_torch.py
    python examples/profile_decode_torch.py --src /path/to/other/src

Builds ``--arch`` at full width and depth with random weights (in the
config's dtype) from a seeded generator on the card, and a zero KV
cache of ``--max-len`` slots for ``--batch`` sequences.  A decode
step's work does not depend on what the cache holds, so no prefill runs:
decoding starts at ``--length`` valid slots.  Then, under
``torch.inference_mode`` as the serving engine decodes:

  * ``--rounds`` rounds of ``--steps`` steps on the host clock, the card
    synchronised before and after each round: ms a step, each round's
    and their median;
  * ``--profiled`` steps under torch.profiler: kernel launches and
    kernel time a step, and the device-busy share (kernel time over the
    median step time of the rounds).

Prints the card's name and power limit, then one JSON line.  ``--src``
imports ``repro_torch`` from another tree's ``src/`` (to compare two
trees on one card in one session, in turns).  Runs on the card only.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--length", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.factory import build_model

    if not torch.cuda.is_available():
        sys.exit("profile_decode_torch: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    cache = model.init_cache(args.batch, args.max_len, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tok = torch.randint(1, cfg.vocab_size, (args.batch, 1), generator=gen,
                        device="cuda")

    def run(n):
        for i in range(n):
            model.decode(params, cache, tok, args.length + i)

    with torch.inference_mode():
        run(3)                                            # warm
        rounds = []
        for _ in range(args.rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(args.steps)
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) * 1e3 / args.steps)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(args.profiled)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    n = args.profiled
    kernel_ms = (sum(e.self_device_time_total for e in kernels) / 1e3 / n
                 if kernels else None)
    print(card)
    print(json.dumps({
        "label": args.label, "src": args.src, "arch": args.arch,
        "n_layers": cfg.n_layers, "batch": args.batch,
        "max_len": args.max_len, "length": args.length,
        "step_ms_rounds": rounds, "step_ms_median": statistics.median(rounds),
        "launches_per_step": (sum(e.count for e in kernels) / n
                              if kernels else None),
        "kernel_ms_per_step": kernel_ms,
        "device_busy": (kernel_ms / statistics.median(rounds)
                        if kernels else None),
        "card": card}))


if __name__ == "__main__":
    main()
