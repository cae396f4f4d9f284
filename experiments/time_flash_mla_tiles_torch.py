"""Times the shared-memory candidates of K1's Hopper forward at MLA's head
dims (q and k 192 columns, v and o 128) on the card, in turns, at a
prefill wave of deepseek-v3-671b: (4, 1024, 1024, 128) bf16, causal.

At 128 kv rows a tile, two Q buffers and two K and V stages would need
256 KB of shared memory, past the 227 KB a block has.  The candidates:

  * ``one-q``: ``MlaTile`` as the source defines it: 128-row kv tiles,
    two stages, one Q buffer (208 KB), so the next unit's Q loads only
    once this unit's last S = Q K^T has landed;
  * ``bk64-3``: two Q buffers and 64-row kv tiles (S m64n64, P half as
    wide) in three stages (216 KB);
  * ``bk64-2``: the same in two stages (176 KB).

Each is a library of its own: the source, and copies of it with the one
line that defines ``MlaTile`` edited (checked to apply), built with the
port's nvcc flags in parallel.  Each is first held to ``attention_ref``
at the wave (worst row relative error within chip_smoke.py's bf16 row
limit), then timed through ``kernel.flash_attention_cuda(...,
"hopper")`` with CUDA events (10 calls after 2), ``--rounds`` times in
the order above and then reversed.  Prints the card's name and power
limit, ptxas's registers and spills of each candidate's MLA kernel, every
turn, and one JSON line.  Needs nvcc and one card:

    python3 experiments/time_flash_mla_tiles_torch.py
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

SHAPE = (4, 1024, 128)              # b, s, h of the MLA wave
HD, DV = 192, 128
ROW_TOL = 1e-2                      # bf16, as chip_smoke.py
TILE_LINE = "using MlaTile = Tile<192, 128, 128, 1, 2>;"
CANDIDATES = {"one-q": None,
              "bk64-3": "using MlaTile = Tile<192, 128, 64, 2, 3>;",
              "bk64-2": "using MlaTile = Tile<192, 128, 64, 2, 2>;"}


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


def sources(out_dir: Path) -> dict:
    """{candidate: source path}: the source, and each edited copy."""
    src = kernel.SOURCE.read_text()
    if src.count(TILE_LINE) != 1:
        raise SystemExit(f"the source does not define MlaTile as "
                         f"{TILE_LINE!r}")
    out = {}
    for name, line in CANDIDATES.items():
        if line is None:
            out[name] = kernel.SOURCE
            continue
        path = out_dir / f"flash_attention_{name}.cu"
        path.write_text(src.replace(TILE_LINE, line))
        out[name] = path
    return out


def mla_kernel_regs(so: Path) -> str:
    """ptxas's line for the serving MLA instantiation (a Tile<192, ...>
    without softcap or LSE) from the library's build log."""
    log = (so.parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Function properties for" in line and re.search(
                r"TileILi192ELi128ELi\d+ELi\d+ELi\d+EEELb0ELb0E", line):
            regs = next(x for x in log[i:] if "registers" in x)
            spill = next(x for x in log[i:] if "spill" in x)
            return f"{regs.split(':', 1)[1].strip()}; {spill.strip()}"
    return "not found in the build log"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    out_dir = _build.BUILD_ROOT / "flash_mla_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = sources(out_dir)
    with ThreadPoolExecutor(len(srcs)) as pool:
        paths = dict(zip(srcs, pool.map(
            lambda kv: _build.build(kv[1], f"flash_attention_{kv[0]}"),
            srcs.items())))
    libs = {name: kernel.typed(ctypes.CDLL(str(so)))
            for name, so in paths.items()}
    for name, so in paths.items():
        print(f"[tiles] {name}: {mla_kernel_regs(so)}")

    b, s, h = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = (torch.randn((b, s, h, HD), generator=gen, device="cuda")
         * 2).bfloat16()
    k = (torch.randn((b, s, h, HD), generator=gen, device="cuda")
         * 2).bfloat16()
    v = torch.randn((b, s, h, DV), generator=gen, device="cuda").bfloat16()
    real = kernel.library
    times, errs = {}, {}
    try:
        with torch.inference_mode():
            ref = attention_ref(q, k, v, causal=True).float()
            for name, lib in libs.items():
                kernel.library = lambda _l=lib: _l
                out = kernel.flash_attention_cuda(q, k, v, "hopper").float()
                errs[name] = ((out - ref).norm(dim=-1) / ref.norm(
                    dim=-1).clamp_min(1e-30)).max().item()
                del out
            del ref
            for turn in range(2 * args.rounds):
                order = list(libs) if turn % 2 == 0 else list(reversed(libs))
                for name in order:
                    kernel.library = lambda _l=libs[name]: _l
                    times.setdefault(name, []).append(time_ms(
                        lambda: kernel.flash_attention_cuda(q, k, v,
                                                            "hopper")))
    finally:
        kernel.library = real
    for name, ts in times.items():
        print(f"[tiles] {name}: worst row rel err {errs[name]:.3e} (limit "
              f"{ROW_TOL:g}); ms {', '.join(f'{t:.4f}' for t in ts)}; mean "
              f"{sum(ts) / len(ts):.4f}")
    print(json.dumps({"shape": [b, s, s, h, HD, DV], "card": card,
                      "row_err": errs, "ms": times}))
    bad = [name for name, e in errs.items() if not e <= ROW_TOL]
    if bad:
        print(f"past the row limit: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
