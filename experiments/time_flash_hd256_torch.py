"""Checks and times K1's Hopper forward at head dim 256 (gemma3-4b) on the
card, beside the general variant and SDPA, and the general backward with
and without the forward's LSE, for the PyTorch port.

    python experiments/time_flash_hd256_torch.py [--rounds 2]

Prints the card's name and power limit and ptxas's registers and spills
of the hd-256 instantiations (the Hopper forward's four, the general
backward's stats kernel with and without the forward's LSE).  Then, in
bf16 from a seeded generator (q, k ~ N(0, 4), v ~ N(0, 1), as
chip_smoke.py):

  * small ragged cases (causal, sq != skv without the causal mask, a
    window that is no multiple of a kv tile, a softcap, a (b, h, s, hd)
    storage, an expanded GQA view): the Hopper forward against
    ``attention_ref`` (elementwise and row limits of chip_smoke.py), its
    training mode's o bit for bit the serving one's and its LSE against
    ``attention_lse``;
  * gemma3-4b's prefill waves (4, 2048, 2048, 8, 256), window 1024 and
    none: the same checks, then in turns (general, hopper, hopper-lse,
    sdpa, sdpa, hopper-lse, hopper, general; ``--rounds`` times, CUDA
    events, 10 calls after 2) beside the bound;
  * gemma3-4b's training shape (2, 2048, 2048, 8, 256), window 1024 and
    none: the general backward with the forward's LSE and without (its
    stats kernel recomputing it), each against ``attention_bwd_ref`` row
    by row, then its stats kernel alone and the whole call in turns.

Ends with one JSON line.  Runs on the card only.
"""
import argparse
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (b, sq, skv, h), causal, window, softcap, layout
SMALL = (((2, 333, 333, 4), True, 0, 0.0, "plain"),
         ((1, 200, 333, 4), False, 0, 0.0, "plain"),
         ((2, 700, 700, 2), True, 257, 0.0, "plain"),
         ((1, 300, 300, 4), True, 0, 30.0, "plain"),
         ((1, 300, 300, 4), True, 0, 0.0, "strided"),
         ((2, 500, 500, 8), True, 0, 0.0, "gqa-view"))
WAVES = (("gemma-local-wave", 1024), ("gemma-global-wave", 0))
TRAIN = (2, 2048, 2048, 8)
TOL, ROW_TOL = 1e-2, 1e-2       # bf16, as chip_smoke.py
LSE_TOL = 2e-5                   # f32 statistics, atol = rtol
HBM, PEAK = 3.35e12, 989e12      # H100 SXM data sheet


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import checks, kernel, kernel_bwd
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse,
                                                         attention_ref)

    if not torch.cuda.is_available():
        sys.exit("time_flash_hd256_torch: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)

    kernel.library()
    kernel_bwd.library()
    ptxas = []
    for lib, frag in ((kernel, r"Li256ELi256ELi64ELi1ELi2E"),
                      (kernel_bwd, r"bwd_stats_bf16ILi256ELb\dE")):
        fn_name = spill = ""
        log = _build.library_path(lib.SOURCE, lib.NAME).parent / "build.log"
        for line in log.read_text().splitlines():
            if "Function properties for" in line:
                fn_name = line.split("for ")[1].strip()
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                m = re.search(frag, fn_name)
                if m:
                    ptxas.append(f"{fn_name}: {line.split(':', 1)[1].strip()}"
                                 f"; {spill}")
    for line in ptxas:
        print(f"[ptxas] {line}")

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, sq, skv, h, layout, hd=256):
        def randn(s, scale, heads=h):
            if layout == "strided":
                x = torch.randn((b, heads, s, hd), generator=gen,
                                device="cuda").transpose(1, 2)
            else:
                x = torch.randn((b, s, heads, hd), generator=gen,
                                device="cuda")
            return (x * scale).to(torch.bfloat16)
        q = randn(sq, 2.0)
        if layout == "gqa-view":
            k = randn(skv, 2.0, 1).expand(b, skv, h, hd)
            v = randn(skv, 1.0, 1).expand(b, skv, h, hd)
        else:
            k, v = randn(skv, 2.0), randn(skv, 1.0)
        return q, k, v

    def row_err(out, ref):
        out, ref = out.float(), ref.float()
        return ((out - ref).norm(dim=-1)
                / ref.norm(dim=-1).clamp_min(1e-30)).max().item()

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

    def forward_checks(name, q, k, v, kw):
        """The Hopper forward (serving and training mode) against the
        plain version; returns (row err, max abs err, lse err)."""
        check_plan = kernel.plan(q, k, v)
        if check_plan != "hopper":
            sys.exit(f"{name}: plan {check_plan}, expected hopper")
        lse = kernel.lse_buffer(q)
        with torch.inference_mode():
            out = kernel.flash_attention_cuda(q, k, v, "hopper", **kw)
            out_t = kernel.flash_attention_cuda(q, k, v, "hopper", lse=lse,
                                                **kw)
            again = kernel.flash_attention_cuda(q, k, v, "hopper", **kw)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, **kw)
            want_lse = attention_lse(q, k, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        excess = ((out.float() - ref.float()).abs() - TOL
                  - TOL * ref.float().abs()).max().item()
        rerr = row_err(out, ref)
        got_lse = lse[..., :q.shape[1]]
        lse_excess = ((got_lse - want_lse).abs() - LSE_TOL
                      - LSE_TOL * want_lse.abs()).max().item()
        lse_err = (got_lse - want_lse).abs().max().item()
        same = torch.equal(out, out_t) and torch.equal(out, again)
        print(f"[check] {name} {tuple(q.shape)} {kw}: max_abs_err "
              f"{err:.3e}, worst row rel err {rerr:.3e} (limits {TOL:g} + "
              f"{TOL:g} |ref|, {ROW_TOL:g}); lse max abs err {lse_err:.3e} "
              f"(limit {LSE_TOL:g} + {LSE_TOL:g} |ref|: excess "
              f"{lse_excess:.3e}); serving, training and again "
              f"{'bit-identical' if same else 'DIFFER'}")
        if not (excess <= 0 and rerr <= ROW_TOL and same
                and math.isfinite(lse_err) and lse_err <= 1e-2):
            sys.exit(f"time_flash_hd256_torch: {name} fails its checks")
        return rerr, err, lse_err, lse_excess

    result = {"card": card, "ptxas": ptxas, "small": [], "waves": {},
              "backward": {}}
    for (b, sq, skv, h), causal, window, softcap, layout in SMALL:
        q, k, v = inputs(b, sq, skv, h, layout)
        kw = dict(causal=causal, window=window, softcap=softcap)
        r = forward_checks(f"small-{layout}", q, k, v, kw)
        result["small"].append({"shape": [b, sq, skv, h], "kw": kw,
                                "layout": layout, "row_err": r[0],
                                "max_abs_err": r[1], "lse_err": r[2],
                                "lse_excess": r[3]})

    for name, window in WAVES:
        b, s, h = 4, 2048, 8
        q, k, v = inputs(b, s, s, h, "plain")
        kw = dict(causal=True, window=window, softcap=0.0)
        r = forward_checks(name, q, k, v, kw)
        lse = kernel.lse_buffer(q)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            i = torch.arange(s, device="cuda")[:, None]
            j = torch.arange(s, device="cuda")[None, :]
            mask = dict(attn_mask=(i >= j) & (i - j < window))
        else:
            mask = dict(is_causal=True)
        calls = {
            "general": lambda: kernel.flash_attention_cuda(
                q, k, v, "general", **kw),
            "hopper": lambda: kernel.flash_attention_cuda(
                q, k, v, "hopper", **kw),
            "hopper-lse": lambda: kernel.flash_attention_cuda(
                q, k, v, "hopper", lse=lse, **kw),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                           **mask)}
        order = ("general", "hopper", "hopper-lse", "sdpa")
        order = order + order[::-1]
        with torch.inference_mode():
            turns = [(u, time_ms(calls[u])) for _ in range(args.rounds)
                     for u in order]
        ms = {u: float(np.mean([t for w, t in turns if w == u]))
              for u in dict(turns)}
        i = np.arange(s)[:, None]
        j = np.arange(s)[None, :]
        allowed = (i >= j) & ((i - j < window) if window else True)
        pairs = int(allowed.sum()) * b * h
        t_bytes = 4 * b * s * h * 256 * 2 / HBM
        t_ops = 4 * 256 * pairs / PEAK
        bound = max(t_bytes, t_ops) * 1e3
        print(f"[time] {name}: in turns "
              f"{', '.join(f'{u} {t:.4f}' for u, t in turns)} ms; mean "
              f"{', '.join(f'{u} {t:.4f}' for u, t in ms.items())} ms; "
              f"bound {bound:.4f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}); hopper / "
              f"sdpa {ms['hopper'] / ms['sdpa']:.2f}, hopper / bound "
              f"{ms['hopper'] / bound:.2f}, general / hopper "
              f"{ms['general'] / ms['hopper']:.2f} | {card}")
        result["waves"][name] = {"row_err": r[0], "lse_err": r[2],
                                 "ms": ms, "turns": turns,
                                 "bound_ms": bound}
        del q, k, v, qt, kt, vt, lse
        torch.cuda.empty_cache()

    for name, window in (("gemma-local-hd256", 1024),
                         ("gemma-global-hd256", 0)):
        b, s, _, h = TRAIN
        q, k, v = inputs(b, s, s, h, "plain")
        kw = dict(causal=True, window=window, softcap=0.0)
        lse = kernel.lse_buffer(q)
        with torch.no_grad():
            o = kernel.flash_attention_cuda(q, k, v, "hopper", lse=lse, **kw)
        do = torch.randn(o.shape, generator=gen, device="cuda").bfloat16()
        with torch.no_grad():
            f32 = [t.float() for t in (q, k, v, o, do)]
            ref = attention_bwd_ref(*f32, **kw)
            scales = checks.bwd_row_scales(*f32, **kw)
            errs = {}
            for how, given in (("forward-lse", lse), ("recomputed", None)):
                got = kernel_bwd.flash_attention_bwd_cuda(
                    q, k, v, o, do, "general", lse=given, **kw)
                again = kernel_bwd.flash_attention_bwd_cuda(
                    q, k, v, o, do, "general", lse=given, **kw)
                same = all(torch.equal(a, c) for a, c in zip(got, again))
                errs[how] = max(checks.grad_row_err(a, r_, m)
                                for a, r_, m in zip(got, ref, scales))
                print(f"[check] {name} general backward, LSE {how}: worst "
                      f"row rel err {errs[how]:.3e} (limit {ROW_TOL:g}); "
                      f"two calls {'bit-identical' if same else 'DIFFER'}")
                if not (errs[how] <= ROW_TOL and same):
                    sys.exit(f"time_flash_hd256_torch: {name} backward "
                             f"({how}) fails its checks")
            del f32, ref, scales
            torch.cuda.empty_cache()
            runs = {
                "stats-lse": kernel_bwd.launcher(q, k, v, o, do, "general",
                                                 lse=lse, kernels=("stats",),
                                                 **kw)[0],
                "stats": kernel_bwd.launcher(q, k, v, o, do, "general",
                                             kernels=("stats",), **kw)[0],
                "call-lse": kernel_bwd.launcher(q, k, v, o, do, "general",
                                                lse=lse, **kw)[0],
                "call": kernel_bwd.launcher(q, k, v, o, do, "general",
                                            **kw)[0]}
            order = ("stats", "stats-lse", "call", "call-lse")
            order = order + order[::-1]
            turns = [(u, time_ms(runs[u])) for _ in range(args.rounds)
                     for u in order]
        ms = {u: float(np.mean([t for w, t in turns if w == u]))
              for u in dict(turns)}
        print(f"[time] {name} general backward: in turns "
              f"{', '.join(f'{u} {t:.4f}' for u, t in turns)} ms; mean "
              f"{', '.join(f'{u} {t:.4f}' for u, t in ms.items())} ms | "
              f"{card}")
        result["backward"][name] = {"row_err": errs, "ms": ms,
                                    "turns": turns}
        del q, k, v, o, do, lse
        torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
