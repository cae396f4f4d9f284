"""Where the time of K3's backward reverse pass goes: its "bwd" kernel
timed at the training shape (4, 2048, 16384, 16) bf16 beside copies of its
source with one part of the design undone or knocked out, and PR 24's
form, in turns.

Each copy is a text edit of ``csrc/selective_scan_bwd.cu`` (checked to
apply) built as a library of its own with the port's nvcc flags.  Two
undo a part of the design and still compute the gradients:

* "decays stored once": the recompute stores its decays in shared memory
  (K x 256 lanes x N/4 f32, 64 KB a block at N = 16, the warps' sums of a
  step written over the warp's decays of that step once read) and the
  walk back reads them: one exponential an entry and step, where the
  design forms each decay again;
* "staging unoverlapped": the next sub-chunk's copies are issued after the
  walk back, so nothing overlaps their loads.

The others knock a part out:

* "dB/dC shuffles": the reduce-scatters of dB and dC over a warp's
  channels left out (each lane's own sum kept);
* "staging": the next sub-chunk's copies and their conversion skipped
  (every sub-chunk reads the last one's rows);
* "write-out": the dx, ddt and dB/dC partials' stores skipped;
* "orders unpadded": the B and C tiles of the NQ lane orders without
  their 16-float pads, so a quarter-warp's two orders share banks.

A knocked-out kernel computes wrong gradients (printed, not a failure):
each line is a time only.  The design and PR 24's form are held to
``checks.BWD_ROW_TOL`` first.  Needs nvcc and one card:

    python3 experiments/scan_bwd_knockouts_torch.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mamba_scan import checks, kernel_bwd  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref  # noqa: E402

SHAPE = (4, 2048, 16384, 16)
KNOCKOUTS = {
    "decays stored once": [
        ("  static constexpr int SUMW = 2 * NP + 16;",
         "  static constexpr int SUMW = 32 * NQ;"),
        ("        hs[tt + 1][i] = fmaf(e[i], hs[tt][i], v.y * bq[i]);\n"
         "      }\n",
         "        hs[tt + 1][i] = fmaf(e[i], hs[tt][i], v.y * bq[i]);\n"
         "      }\n"
         "      store_vec<NQ>(sums + (tt * THREADS + tid) * NQ, e);\n"),
        ("#pragma unroll\n"
         "      for (int i = 0; i < NQ; ++i) e[i] = ex2_approx(dtv * a2[i]);",
         "      load_vec<NQ>(sums + (tt * THREADS + tid) * NQ, e);"),
        ("      float* at = sums + (tt * WARPS + warp) * L::SUMW;",
         "      __syncwarp();\n"
         "      float* at = sums + (tt * WARPS + warp) * L::SUMW;")],
    "staging unoverlapped": [
        ("    if (k > 0) issue(k - 1);\n", ""),
        ("    copy_wait_all();\n    __syncthreads();\n\n    // dB/dC",
         "    if (k > 0) issue(k - 1);\n"
         "    copy_wait_all();\n    __syncthreads();\n\n    // dB/dC")],
    "dB/dC shuffles": [(
        "      const float rb = sum_scatter<NQ>(vb);\n"
        "      const float rc = sum_scatter<NQ>(vc);",
        "      const float rb = vb[0], rc = vc[0];")],
    "staging": [("    if (k > 0) issue(k - 1);", "    if (k < 0) issue(k - 1);"),
                ("    if (k > 0) convert();", "    if (k < 0) convert();")],
    "write-out": [("        if (tt < K && t0 + tt < p.s) {",
                   "        if (tt < K && t0 + tt < -p.s) {"),
                  ("        if (col && t0 + tt < p.s) {",
                   "        if (col && t0 + tt < -p.s) {")],
    "orders unpadded": [("  static constexpr int ORDER = K * NP + 16;",
                         "  static constexpr int ORDER = K * NP;")],
}


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
    """{name: source path}: the design and each knockout's copy."""
    src = kernel_bwd.SOURCE.read_text()
    out = {"design": kernel_bwd.SOURCE}
    for name, edits in KNOCKOUTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"knockout {name!r} does not apply: {old!r}")
            text = text.replace(old, new)
        path = out_dir / f"knockout_{len(out)}.cu"
        path.write_text(text)
        out[name] = path
    return out


def load(path: Path, tag: str):
    lib = ctypes.CDLL(str(_build.build(path, tag)))
    fn = lib.selective_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out_dir = _build.BUILD_ROOT / "scan_bwd_knockouts"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = sources(out_dir)
    with ThreadPoolExecutor(len(srcs) + 1) as pool:
        first = pool.submit(kernel_bwd.build, True)
        libs = dict(zip(srcs, pool.map(
            lambda kv: load(kv[1], f"scan_bwd_knockout{list(srcs).index(kv[0])}"),
            srcs.items())))
        first.result()
    gen = torch.Generator(device="cuda").manual_seed(0)
    *args, dy, _ = checks.bwd_inputs(SHAPE, torch.bfloat16, gen)
    ck = kernel_bwd.forward_checkpoints(*args)
    with torch.no_grad():
        ref = selective_scan_bwd_ref(*args, dy)
        scales = checks.bwd_row_scales(*args, dy)
    real = kernel_bwd.library
    times, ok = {}, {}
    try:
        for turn in range(2):
            order = list(libs) if turn == 0 else list(reversed(libs))
            for name in order:
                kernel_bwd.library = lambda sweep=False, _l=libs[name]: _l
                if turn == 0:
                    got = kernel_bwd.selective_scan_bwd_cuda(
                        *args, dy, checkpoints=ck)
                    ok[name] = checks.bwd_within(
                        checks.bwd_errors(got, ref, scales), torch.bfloat16)
                    del got
                times.setdefault(name, []).append(time_ms(
                    lambda: kernel_bwd.selective_scan_bwd_cuda(
                        *args, dy, kernels=("bwd",), checkpoints=ck)))
            kernel_bwd.library = real
            times.setdefault("PR 24's form", []).append(time_ms(
                lambda: kernel_bwd.selective_scan_bwd_cuda(
                    *args, dy, kernels=("bwd",), design="first",
                    sweep=True)))
    finally:
        kernel_bwd.library = real
    if not ok["design"]:
        print("the design's gradients are past the limits", file=sys.stderr)
        return 1
    base = sum(times["design"]) / 2
    for name, ts in times.items():
        mean = sum(ts) / len(ts)
        tag = ("" if name in ("design", "PR 24's form") else
               f", {mean - base:+.4f} ms against the design" + (
                   " (gradients within the limits)" if ok.get(name)
                   else " (gradients wrong: a time only)"))
        print(f"[knockout] {name}: bwd alone {', '.join(f'{t:.4f}' for t in ts)}"
              f" ms{tag}")
    print(json.dumps({"shape": SHAPE, "card": card, "bwd_ms": times}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
