"""Times K1's Hopper forward at head dim 120 (h2o-danube-3-4b) on the
card, in forms that differ only in how hd 120 is laid out, in turns,
beside hd 128, for the PyTorch port.

    python experiments/time_flash_hd120_torch.py

At each shape, bf16 q/k/v from a seeded generator, through
``kernel.flash_attention_cuda(..., "hopper")``:

  * ``n128``: q/k/v contiguous (b, s, h, 120): two 64-column TMA boxes
    a row, the second's columns 120..127 zeros TMA writes, P V as
    m64n128k16;
  * ``padded``: q/k/v that are the first 120 columns of a (b, s, h, 128)
    storage (every row 256-byte aligned, where a contiguous hd-120 row
    starts 240 bytes after the last);
  * ``hd128``: hd 128, the same shape otherwise.

Each form runs ``--rounds`` times in the order given and then reversed
(CUDA events, 10 calls after 2), after its output is checked against
``n128``'s (worst row relative error; hd128 excepted).  Prints the
card's name and power limit, ptxas's registers and spills of the hd-120
instantiations, each turn, and one JSON line.  Runs on the card only.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (b, s, h), window: danube's prefill wave and the serving shape
SHAPES = (((4, 6144, 32), 4096), ((4, 1024, 32), 0))
FORMS = ("n128", "padded", "hd128")
ROW_TOL = 1e-2          # bf16, as chip_smoke.py


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import kernel

    if not torch.cuda.is_available():
        sys.exit("time_flash_hd120_torch: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)

    kernel.library()                                      # build
    fn_name = spill = ""
    for line in (kernel.library_path().parent
                 / "build.log").read_text().splitlines():
        if "Function properties for" in line:
            fn_name = line.split("for ")[1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            tpl = re.search(r"ILi120ELb(\d)ELb(\d)E", fn_name)
            if tpl:
                print(f"[ptxas] flash_fwd_hopper_kernel<120, "
                      f"{tpl.group(1)}, {tpl.group(2)}>: "
                      f"{line.split(':', 1)[1].strip()}; {spill}")

    def call(q, k, v, window):
        return kernel.flash_attention_cuda(q, k, v, "hopper", causal=True,
                                           window=window)

    def time_ms(fn, iters=10, warmup=2):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def row_err(out, ref):
        out, ref = out.float(), ref.float()
        return ((out - ref).norm(dim=-1)
                / ref.norm(dim=-1).clamp_min(1e-30)).max().item()

    result = {"card": card, "shapes": []}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, s, h), window in SHAPES:
        def randn(hd, scale):
            x = torch.randn((b, s, h, hd), generator=gen, device="cuda")
            return (x * scale).to(torch.bfloat16)

        wide = [randn(128, sc) for sc in (2.0, 2.0, 1.0)]
        inputs = {"n128": [t[..., :120].contiguous() for t in wide],
                  "padded": [t[..., :120] for t in wide], "hd128": wide}
        with torch.inference_mode():
            base = call(*inputs["n128"], window)
            errs = {"padded": row_err(call(*inputs["padded"], window),
                                      base)}
            torch.cuda.synchronize()
            print(f"[check] {(b, s, h, 120)} window {window}: worst row "
                  f"rel err against n128 {errs} (limit {ROW_TOL:g})")
            if not all(e <= ROW_TOL for e in errs.values()):
                sys.exit("time_flash_hd120_torch: a form disagrees")
            order = FORMS + FORMS[::-1]
            turns = [(f, time_ms(lambda: call(*inputs[f], window)))
                     for _ in range(args.rounds) for f in order]
        ms = {f: float(np.mean([t for g, t in turns if g == f]))
              for f in FORMS}
        print(f"[time] {(b, s, h)} window {window}: in turns "
              f"{', '.join(f'{f} {t:.4f}' for f, t in turns)} ms; mean "
              f"{', '.join(f'{f} {t:.4f}' for f, t in ms.items())} ms | "
              f"{card}")
        result["shapes"].append({"shape": [b, s, s, h], "window": window,
                                 "row_err": errs, "ms": ms, "turns": turns})
        del wide, inputs, base
        torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
