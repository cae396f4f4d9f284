"""Times a decoder's prefill wave on the card, with the time and the
launches of its kernels, for the PyTorch port.

    python experiments/profile_prefill_torch.py
    python experiments/profile_prefill_torch.py --src /path/to/other/src

Builds h2o-danube-3-4b at full width and depth with random weights (in
the config's dtype) from a seeded generator on the card, and BATCH
prompts of SEQ seeded random tokens (the 4 x 6144 wave of chip_smoke.py,
past the 4096 window).  Then, under ``torch.inference_mode`` as the
serving engine prefills, into a cache of MAX_LEN slots:

  * ROUNDS prefill waves on the host clock, the card synchronised
    before and after each: ms a wave, each wave's and their median;
  * one wave under torch.profiler: its kernel time and launches, the
    device-busy share (kernel time over the median wave), the kernels
    that take the most, and K1's (flash attention's) launches by variant
    (``ops.launches_by_variant``) and their kernel time.

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

ARCH = "h2o-danube-3-4b"
BATCH, SEQ, MAX_LEN = 4, 6144, 6160
ROUNDS = 3
TOP = 8                 # kernels printed, by time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.factory import build_model

    if not torch.cuda.is_available():
        sys.exit("profile_prefill_torch: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cfg = get_config(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (BATCH, SEQ),
                         generator=gen, device="cuda")

    def run():
        logits, _, _ = model.prefill(params, toks, MAX_LEN)
        return logits

    with torch.inference_mode():
        logits = run()                                    # warm
        finite = bool(torch.isfinite(logits).all())
        del logits
        waves = []
        for _ in range(ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            waves.append((time.perf_counter() - t0) * 1e3)
        before = dict(flash_ops.launches_by_variant)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        k1_by_variant = {v: n - before[v]
                         for v, n in flash_ops.launches_by_variant.items()}
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1 = [e for e in kernels if "flash_fwd" in e.key]
    wave_ms = statistics.median(waves)
    print(card)
    for e in kernels[:TOP]:
        print(f"[profile] {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:5d}x  {e.key[:90]}")
    print(json.dumps({
        "label": args.label, "src": args.src, "arch": ARCH,
        "n_layers": cfg.n_layers, "batch": BATCH, "seq": SEQ,
        "max_len": MAX_LEN, "logits_finite": finite,
        "wave_ms_rounds": waves, "wave_ms_median": wave_ms,
        "kernel_ms": kernel_ms if kernels else None,
        "launches": sum(e.count for e in kernels) if kernels else None,
        "device_busy": kernel_ms / wave_ms if kernels else None,
        "k1_launches_by_variant": k1_by_variant,
        "k1_kernel_ms": sum(e.self_device_time_total for e in k1) / 1e3,
        "k1_kernel_count": sum(e.count for e in k1),
        "card": card}))
    if not finite:
        sys.exit("profile_prefill_torch: non-finite logits")


if __name__ == "__main__":
    main()
