#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from a checkout of the repository; it needs one CUDA card and nothing
but the sources in the checkout.  Phases, in order; any failure exits
non-zero and prints no result:

1. device: require CUDA, print the card's name and power limit;
2. build: compile every kernel of the serving paths with nvcc (sm_90a),
   one nvcc per source, all started together;
3. kernels: hold each kernel against its plain torch version on the card
   at the main-path shape and at edge shapes, elementwise and row by row,
   show that a deliberately wrong result would fail the checks, and time
   the kernel, the plain version and (where one exists) a PyTorch
   library call as a yardstick: flash attention (K1), WKV6 (K2), then
   the Mamba selective scan (K3); K1's two variants (the Hopper one
   that the serving shapes take, and the general one) in turns at the
   main-path shape and at Jamba's 64 heads, each case checked for the
   variant it took;
4. main paths, each with every kernel's launch count set to 0 just
   before it and read just after, served through the port's rFaaS stack
   (ModelServer, ServeEngine, Invoker, ResourceManager, BatchSystem,
   Ledger) at full width in bf16 with seeded random weights: 8 requests,
   batch 4, prompts of 256-1024 tokens, 16 new tokens each, max_len
   2048; each checks that every request gets its tokens, every logit is
   finite and each of its kernels ran as often per prefill wave as the
   path has layers that run it (and no other kernel ran), every K1
   launch through the Hopper variant; the device
   memory of the path before is freed first:
   a. mistral-nemo-12b (40 layers, d_model 5120): K1 40 times a wave;
   b. rwkv6-1.6b (24 layers, d_model 2048): K2 24 times a wave;
   c. jamba-1.5-large-398b cut in depth to 4 layers, every width as
      published (d_model 8192, 16 experts of 24576, d_inner 16384):
      layers 4-7 of a published period (attention + MLP, Mamba + MoE,
      Mamba + MLP, Mamba + MoE), 23.0 B params; K1 once and K3 3 times
      a wave.  One period (8 layers) would be 45.2 B params, 90.4 GB in
      bf16: more than the card holds.
   With --profile, after each, one prefill wave and three decode steps
   outside the engine, timed and traced with torch.profiler;
5. decode vs prefill: full-width f32 models of each path, cut to 2
   layers (Jamba: layers 4-5 of a period, attention + MLP then Mamba +
   MoE with all 16 experts, capacity factor 16 so that no token drops),
   teacher-forced decode against one forward over the whole sequence;
6. the kernels line, the card line and the result line, last.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
JAMBA = "jamba-1.5-large-398b"
# Depth cuts of the published configs; every width stays as published.
# Jamba's main path: layers 4-7 of a period (one attention layer, then
# three Mamba layers, MoE on the 2nd and 4th).
PATH_CUTS = {JAMBA: dict(n_layers=4, attn_layer_period=4,
                         attn_layer_offset=0)}
# Decode-vs-prefill models: 2 layers each; Jamba's are layers 4-5 of a
# period (attention + MLP, Mamba + MoE).
DECODE_CUTS = {"mistral-nemo-12b": dict(n_layers=2),
               "rwkv6-1.6b": dict(n_layers=2),
               JAMBA: dict(n_layers=2, attn_layer_period=2,
                           attn_layer_offset=0)}
# each main path and the launches of each kernel per prefill wave: one
# per layer that runs it
MAIN_PATHS = {"mistral-nemo-12b": {"flash_attention": 40},
              "rwkv6-1.6b": {"wkv6": 24},
              JAMBA: {"flash_attention": 1, "selective_scan": 3}}
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,          # dense tensor cores
              torch.float32: 67e12}            # CUDA cores, no TF32
# exp2 on the SFUs: 16 results a clock per SM (CUDA C++ programming
# guide, arithmetic instruction throughput, compute capability 9.0), at
# 132 SMs and the 1.98 GHz boost clock of the H100 SXM
PEAK_EXP_PER_S = 16 * 132 * 1.98e9
# f32 FMA-pipe instructions: 128 a clock per SM; and what one exp2 costs
# there as a polynomial (range reduction and a degree-3 polynomial with
# the exponent added to the bits, as FlashAttention-4 does), to state
# the floor when part of the exponentials leave the SFUs
PEAK_FMA_INSTR_PER_S = 128 * 132 * 1.98e9
POLY_EXP2_INSTR = 6
# Elementwise limit (atol = rtol).  f32: the kernel tests' 2e-5.  bf16:
# both sides round the output to bf16, and at |out| ~ 1-4 one bf16 ulp is
# 0.008-0.03, so an absolute 1e-2 plus 1e-2 of |ref|.
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# Limit on ||out - ref|| / ||ref|| of every (b, q, h) row.  bf16: the
# kernel rounds P to bf16 (relative 2^-9) and the output to bf16 (2^-9),
# so ~3e-3 at most.  A row that loses the key it attends to errs by O(1).
ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# name, (b, sq, skv, h, hd), dtype, causal, window, softcap, strided, the
# variant kernel.plan must pick
FLASH_CASES = [
    ("main-path", (4, 1024, 1024, 32, 128), torch.bfloat16, True, 0, 0.0,
     False, "hopper"),
    ("window", (1, 257, 257, 4, 64), torch.float32, True, 64, 0.0, False,
     "general"),
    ("minicpm-hd12", (2, 100, 100, 6, 12), torch.float32, True, 0, 0.0,
     False, "general"),
    ("softcap-hd256", (1, 96, 96, 2, 256), torch.bfloat16, True, 0, 30.0,
     False, "general"),
    ("ragged-noncausal", (1, 64, 192, 2, 64), torch.float32, False, 0, 0.0,
     False, "general"),
    ("strided-gemma-hd16", (2, 130, 130, 4, 16), torch.float32, True, 16,
     0.0, True, "general"),
    ("ragged-wave", (4, 916, 916, 32, 128), torch.bfloat16, True, 0, 0.0,
     False, "hopper"),
    ("window-257", (2, 700, 700, 8, 128), torch.bfloat16, True, 257, 0.0,
     False, "hopper"),
    ("window-64", (1, 257, 257, 4, 64), torch.bfloat16, True, 64, 0.0,
     False, "hopper"),
    ("noncausal-hd64", (1, 200, 333, 4, 64), torch.bfloat16, False, 0, 0.0,
     False, "hopper"),
    ("softcap-30", (1, 300, 300, 4, 128), torch.bfloat16, True, 0, 30.0,
     False, "hopper"),
    ("strided-hd128", (1, 300, 300, 4, 128), torch.bfloat16, True, 0, 0.0,
     True, "hopper"),
    ("jamba-64-heads", (4, 1024, 1024, 64, 128), torch.bfloat16, True, 0,
     0.0, False, "hopper"),
]


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2):
    """Mean device time of one call, from CUDA events around ``iters``
    calls after ``warmup`` calls."""
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


# ------------------------------------------------------------------ phases


def kernel_ops():
    """The dispatcher module of every kernel, by name; each counts its
    launches in ``launches``."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    return {"flash_attention": flash_ops, "wkv6": wkv_ops,
            "selective_scan": scan_ops}


def phase_build():
    """One nvcc per kernel source, all started together (each module's
    ``build()`` in a thread of its own), then each library loaded."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    modules = (flash_kernel, wkv_kernel, scan_kernel)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        paths = list(pool.map(lambda m: m.build(), modules))
    for m in modules:
        m.library()
    dt = time.perf_counter() - t0
    print(f"[build] {', '.join(m.NAME for m in modules)} (in parallel) in "
          f"{dt:.1f} s")
    for m, so in zip(modules, paths):
        print(f"[build] {m.NAME} -> {so.relative_to(ROOT)}")
        log = so.parent / "build.log"
        if log.exists():
            for line in ptxas_summary(log.read_text()):
                print(f"[build]   {line}")


def _demangle(mangled):
    """`flash_fwd_hopper_kernel<128, 0>` from the mangled name of a kernel
    template in a namespace (its last name and its integer arguments)."""
    rest, names = mangled.strip()[3:], []       # after "_ZN"
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group(0)
        rest = rest[len(n):]
        names.append(rest[:int(n)])
        rest = rest[int(n):]
    args = re.findall(r"L[a-z](\d+)E", rest)
    return f"{names[-1]}<{', '.join(args)}>" if names else mangled.strip()


def ptxas_summary(log):
    """One line per kernel of nvcc's -Xptxas -v output: the kernel (its
    template arguments), registers, spills, static shared memory, and any
    performance warning of ptxas."""
    out, name = [], None
    for line in log.splitlines():
        if "Function properties for " in line:
            name = _demangle(line.split("Function properties for ")[1])
        elif "spill" in line and name:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
        elif "Performance Loss" in line:
            out.append(line.strip().split(" in the function")[0])
    return out


def _flash_inputs(shape, dtype, strided, gen):
    """q, k ~ N(0, 4) and v ~ N(0, 1): scores q.k/sqrt(hd) have standard
    deviation 4, so each row's softmax is peaked on a few keys and |out|
    is O(1) in every row, however many keys it sees.  A kernel that
    loses or doubles any kv tile then moves the rows that attend into it
    by O(1), which the checks see."""
    b, sq, skv, h, hd = shape

    def randn(s, scale):
        if strided:       # (b, h, s, hd) storage seen as (b, s, h, hd)
            x = torch.randn((b, h, s, hd), generator=gen, device="cuda")
            x = x.transpose(1, 2)
        else:
            x = torch.randn((b, s, h, hd), generator=gen, device="cuda")
        return (x * scale).to(dtype)

    return randn(sq, 2.0), randn(skv, 2.0), randn(skv, 1.0)


def row_err(out, ref):
    """Worst ||out - ref|| / ||ref|| over the (b, q, h) rows."""
    out, ref = out.float(), ref.float()
    return ((out - ref).norm(dim=-1)
            / ref.norm(dim=-1).clamp_min(1e-30)).max().item()


def flash_bound(shape, dtype, causal, window):
    """Least time for the function: bytes (q, k, v read once, o written
    once) over HBM bandwidth, or the products of the unmasked (query,
    key) pairs over the peak rate for the dtype, whichever is larger."""
    b, sq, skv, h, hd = shape
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * sq * h * hd + 2 * b * skv * h * hd) * size
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= i >= j
    if window:
        mask &= i - j < window
    flops = 4 * hd * int(mask.sum()) * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_flash():
    """K1, each case: kernel vs plain version, tolerance by dtype, and the
    variant the dispatcher took.  Returns the kernels-line entry (numbers
    at the main-path case, the 64-head case's beside them)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entry, jamba = None, None
    for (name, shape, dtype, causal, window, softcap, strided,
         variant) in FLASH_CASES:
        q, k, v = _flash_inputs(shape, dtype, strided, gen)
        kw = dict(causal=causal, window=window, softcap=softcap)
        before = dict(flash_ops.launches_by_variant)
        with torch.inference_mode():
            out = flash_ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, **kw)
        took = [vt for vt, n in flash_ops.launches_by_variant.items()
                if n != before[vt]]
        err = (out.float() - ref.float()).abs().max().item()
        rerr = row_err(out, ref)
        tol, rtol = TOL[dtype], ROW_TOL[dtype]
        print(f"[kernels] flash_attention {name} {tuple(shape)} "
              f"{str(dtype)[6:]} causal={causal} window={window} "
              f"softcap={softcap} strided={strided}, variant {took}: "
              f"max_abs_err {err:.3e} (limit {tol:g} + {tol:g} x |ref|), "
              f"worst row rel err {rerr:.3e} (tol {rtol:g})")
        check(took == [variant], f"flash_attention {name}: took {took}, "
                                 f"expected [{variant!r}]")
        check(math.isfinite(err), f"flash_attention {name}: non-finite")
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
        check(rerr <= rtol, f"flash_attention {name}: worst row rel err "
                            f"{rerr:.3e} > {rtol:g}")
        if name == "jamba-64-heads":
            jamba = _time_flash(flash_kernel, F, q, k, v, shape, dtype, kw,
                                name)
        if name != "main-path":
            del q, k, v, out, ref
            continue
        # The checks can fail here: the plain version with the values of
        # one middle kv tile zeroed (what a kernel that lost the tile
        # would return), and with kv rows [512, 640) replaced by rows
        # [384, 512) (what a ring stage read with a stale phase would
        # hold), must each be far outside the row limit.
        with torch.inference_mode():
            v_lost = v.clone()
            v_lost[:, 512:576] = 0
            lost = row_err(attention_ref(q, k, v_lost, **kw), ref)
            del v_lost
            k_stale, v_stale = k.clone(), v.clone()
            k_stale[:, 512:640] = k[:, 384:512]
            v_stale[:, 512:640] = v[:, 384:512]
            stale = row_err(attention_ref(q, k_stale, v_stale, **kw), ref)
            del k_stale, v_stale
        print(f"[kernels] flash_attention main-path: a lost kv tile "
              f"[512, 576) gives worst row rel err {lost:.3e}; a stale "
              f"stage (kv [512, 640) read as [384, 512)) {stale:.3e} (limit "
              f"{rtol:g})")
        check(lost > 10 * rtol, f"a lost kv tile gives only {lost:.3e}: "
                                f"the check cannot see it")
        check(stale > 10 * rtol, f"a stale stage gives only {stale:.3e}: "
                                 f"the check cannot see it")
        entry = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
            "launches": None, "max_abs_err": err,
            **_time_flash(flash_kernel, F, q, k, v, shape, dtype, kw, name,
                          plain=lambda: attention_ref(q, k, v, **kw)),
        }
        del q, k, v, out, ref
    check(entry is not None and jamba is not None,
          "flash_attention: a timed case did not run")
    entry["jamba_64_heads"] = jamba
    torch.cuda.empty_cache()
    return entry


def _time_flash(flash_kernel, F, q, k, v, shape, dtype, kw, name,
                plain=None):
    """Times both variants of K1 in turns (general, hopper, hopper,
    general) through the kernel module (no launch counted), SDPA on the
    same inputs, and the plain version if given; prints them beside the
    bound and returns the kernels-line numbers (``ms`` is the Hopper
    variant's, which the main paths take)."""
    turns = []
    with torch.inference_mode():
        for variant in ("general", "hopper", "hopper", "general"):
            turns.append((variant, time_ms(
                lambda: flash_kernel.flash_attention_cuda(q, k, v, variant,
                                                          **kw))))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=kw["causal"]))
        plain_ms = time_ms(plain, iters=3) if plain is not None else None
    by_variant = {vt: [t for u, t in turns if u == vt]
                  for vt in ("hopper", "general")}
    ms_by_variant = {vt: float(np.mean(ts)) for vt, ts in by_variant.items()}
    bound_ms, bound_by = flash_bound(shape, dtype, kw["causal"],
                                     kw["window"])
    plain_txt = f", plain {plain_ms:.4f} ms" if plain is not None else ""
    print(f"[kernels] flash_attention {name}: in turns "
          f"{', '.join(f'{u} {t:.4f}' for u, t in turns)} ms; hopper "
          f"{ms_by_variant['hopper']:.4f} ms, general "
          f"{ms_by_variant['general']:.4f} ms{plain_txt}, sdpa "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"hopper / sdpa {ms_by_variant['hopper'] / library_ms:.2f}, "
          f"general / hopper "
          f"{ms_by_variant['general'] / ms_by_variant['hopper']:.2f}")
    out = {"ms": ms_by_variant["hopper"], "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "ms_by_variant": ms_by_variant,
           "ms_turns": turns}
    if plain is None:
        del out["plain_ms"]
    return out


# WKV6 (K2): inputs and limits from repro_torch.kernels.rwkv6.checks.
# name, (b, s, H, hd), dtype, strided, scale of the initial state
WKV_CASES = [
    ("main-path", (4, 1024, 32, 64), torch.bfloat16, False, 0.0),
    ("s1", (2, 1, 32, 64), torch.float32, False, 10.0),
    ("s37-hd16-strided", (2, 37, 4, 16), torch.float32, True, 10.0),
    ("s37-hd16", (3, 37, 4, 16), torch.bfloat16, False, 10.0),
    ("s1000-strided", (2, 1000, 8, 64), torch.bfloat16, True, 10.0),
    ("s1024-f32", (1, 1024, 8, 64), torch.float32, False, 10.0),
    ("s100-hd24", (2, 100, 4, 24), torch.float32, False, 10.0),
]


def wkv_bound(shape, dtype):
    """Least time for the function: bytes (r, k, v in ``dtype``, w f32
    and the state read once; y and the state written once) over HBM
    bandwidth, or its f32 operations over the f32 peak, whichever is
    larger.  Operations per (b, h, step): 4 hd^2 + 5 hd.  With the state
    kept scaled by the running product of the decays (rescaled once per
    chunk, a cost that vanishes with the chunk's length), S += k^T v is
    one FMA per entry and y = (r*D).S one more: 2 hd^2 each; the u term
    and the decay products are O(hd)."""
    b, s, h, hd = shape
    size = torch.finfo(dtype).bits // 8
    n = b * s * h * hd
    nbytes = 4 * n * size + 4 * n + h * hd * size + 2 * b * h * hd * hd * 4
    flops = b * h * s * (4 * hd * hd + 5 * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _close(out, ref, tol, row_tol, what):
    """Elementwise and row checks; returns (max_abs_err, worst row)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    rerr = row_err(out, ref)
    check(math.isfinite(err), f"{what}: non-finite")
    scale = ref.pow(2).mean().sqrt().item()
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol * scale)
    check(rerr <= row_tol, f"{what}: worst row rel err {rerr:.3e} > "
                           f"{row_tol:g}")
    return err, rerr


def phase_wkv6():
    """K2, each case: kernel vs plain version, y and the final state.
    Returns the kernels-line entry (numbers at the main-path case)."""
    from repro_torch.kernels.rwkv6 import checks
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    entry = None
    for name, shape, dtype, strided, state_scale in WKV_CASES:
        args = checks.inputs(shape, dtype, gen, strided, state_scale)
        with torch.inference_mode():
            y, S = wkv_ops.wkv6(*args)
            torch.cuda.synchronize()
            y_ref, S_ref = wkv6_ref(*args)
        check(y.dtype == dtype and S.dtype == torch.float32,
              f"wkv6 {name}: dtypes {y.dtype}, {S.dtype}")
        tol, rtol = checks.TOL[dtype], checks.ROW_TOL[dtype]
        err, rerr = _close(y, y_ref, tol, rtol, f"wkv6 {name} y")
        s_err, s_rerr = _close(S, S_ref, checks.STATE_TOL,
                               checks.STATE_ROW_TOL,
                               f"wkv6 {name} state")
        print(f"[kernels] wkv6 {name} {tuple(shape)} {str(dtype)[6:]} "
              f"strided={strided} state x{state_scale:g}: y max_abs_err "
              f"{err:.3e} (limit {tol:g} x (rms + |ref|), rms "
              f"{y_ref.float().pow(2).mean().sqrt().item():.3g}), worst row "
              f"{rerr:.3e} (tol {rtol:g}); state max_abs_err {s_err:.3e}, "
              f"worst row {s_rerr:.3e} (tol {checks.STATE_ROW_TOL:g})")
        if name != "main-path":
            continue
        # The checks can fail here: the plain version with the update at
        # t = s/2 dropped (k = 0, w = 1 there: the state skips the step,
        # as a kernel that lost it would) must be far outside the limits.
        r, k, v, w, u, state = args
        half = shape[1] // 2
        with torch.inference_mode():
            k_drop, w_drop = k.clone(), w.clone()
            k_drop[:, half] = 0
            w_drop[:, half] = 1
            y_drop, S_drop = wkv6_ref(r, k_drop, v, w_drop, u, state)
            lost, s_lost = row_err(y_drop, y_ref), row_err(S_drop, S_ref)
            del k_drop, w_drop, y_drop, S_drop
        print(f"[kernels] wkv6 main-path: the update at t = {half} dropped "
              f"gives worst row rel err {lost:.3e} in y (limit {rtol:g}) "
              f"and {s_lost:.3e} in the state (limit "
              f"{checks.STATE_ROW_TOL:g})")
        check(lost > 10 * rtol and s_lost > 10 * checks.STATE_ROW_TOL,
              f"a dropped update gives only {lost:.3e} / {s_lost:.3e}: the "
              f"check cannot see it")
        with torch.inference_mode():
            ms = time_ms(lambda: wkv_ops.wkv6(*args))
            plain_ms = time_ms(lambda: wkv6_ref(*args), iters=2, warmup=1)
        bound_ms, bound_by = wkv_bound(shape, dtype)
        print(f"[kernels] wkv6 main-path: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, no library call, bound {bound_ms:.4f} ms "
              f"({bound_by})")
        entry = {
            "name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:49",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        }
        del args, y, S, y_ref, S_ref
    torch.cuda.empty_cache()
    return entry


# Selective scan (K3): inputs and limits from
# repro_torch.kernels.mamba_scan.checks.
# name, (b, s, di, N), dtype, scale of the initial state
SCAN_CASES = [
    ("main-path", (4, 1024, 16384, 16), torch.bfloat16, 0.0),
    ("f32", (2, 1024, 2048, 16), torch.float32, 10.0),
    ("s33-di1000", (2, 33, 1000, 16), torch.bfloat16, 10.0),
    ("s2", (2, 2, 16384, 16), torch.float32, 10.0),
    ("n8", (2, 100, 512, 8), torch.float32, 10.0),
    ("n4-di200", (3, 37, 200, 4), torch.bfloat16, 10.0),
    ("state-f32", (1, 64, 16384, 16), torch.float32, 10.0),
]


def scan_bound(shape, dtype):
    """Least time for the function, the largest of three: bytes (x, B, C
    in ``dtype``, dt f32, A, D and the state read once; y and the state
    written once) over HBM bandwidth; its exponentials, one per state
    entry and step, over the SFUs' exp2 rate; its f32 operations, 6 per
    state entry and step (dt*A, dx*B, the state's FMA, the y FMA) and 3
    per channel and step (dt*x, D*x + y), over the f32 peak."""
    b, s, di, n = shape
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * s * di * size + 4 * b * s * di + 2 * b * s * n * size
              + 4 * (di * n + di) + 2 * 4 * b * di * n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_exp = b * s * di * n / PEAK_EXP_PER_S
    t_flops = b * s * di * (6 * n + 3) / PEAK_FLOPS[torch.float32]
    t_ops = max(t_exp, t_flops)
    # the same work with x of the exponentials as polynomials on the FMA
    # pipe, x chosen so that both pipes take equally long; not the bound
    # (the SFU-only rate is what the kernel's design uses), but the floor
    # a later speed change can aim for
    n_exp, n_fma = b * s * di * n, b * s * di * (4 * n + 2)
    moved = max(0.0, (n_exp * PEAK_FMA_INSTR_PER_S
                      - n_fma * PEAK_EXP_PER_S)
                / (PEAK_FMA_INSTR_PER_S + POLY_EXP2_INSTR * PEAK_EXP_PER_S))
    t_mixed = max((n_exp - moved) / PEAK_EXP_PER_S, t_flops)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "exp": n_exp,
             "flops": b * s * di * (6 * n + 3), "t_bytes_ms": t_bytes * 1e3,
             "t_exp_ms": t_exp * 1e3, "t_flops_ms": t_flops * 1e3,
             "t_ops_sfu_and_fma_ms": t_mixed * 1e3})


def phase_scan():
    """K3, each case: kernel vs plain version, y and the final state.
    Returns the kernels-line entry (numbers at the main-path case)."""
    from repro_torch.kernels.mamba_scan import checks
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    entry = None
    for name, shape, dtype, state_scale in SCAN_CASES:
        args = checks.inputs(shape, dtype, gen, state_scale)
        with torch.inference_mode():
            y, h = scan_ops.selective_scan(*args)
            torch.cuda.synchronize()
            y_ref, h_ref = selective_scan_ref(*args)
        check(y.dtype == dtype and h.dtype == torch.float32,
              f"selective_scan {name}: dtypes {y.dtype}, {h.dtype}")
        tol, rtol = checks.TOL[dtype], checks.ROW_TOL[dtype]
        err, rerr = _close(y, y_ref, tol, rtol, f"selective_scan {name} y")
        h_err, h_rerr = _close(h, h_ref, checks.STATE_TOL,
                               checks.STATE_ROW_TOL,
                               f"selective_scan {name} state")
        print(f"[kernels] selective_scan {name} {tuple(shape)} "
              f"{str(dtype)[6:]} state x{state_scale:g}: y max_abs_err "
              f"{err:.3e} (limit {tol:g} x (rms + |ref|), rms "
              f"{y_ref.float().pow(2).mean().sqrt().item():.3g}), worst row "
              f"{rerr:.3e} (tol {rtol:g}); state max_abs_err {h_err:.3e}, "
              f"worst row {h_rerr:.3e} (tol {checks.STATE_ROW_TOL:g})")
        if name != "main-path":
            continue
        # The checks can fail here: the plain version with the update at
        # t = s/2 dropped (dt = 0 there: the state skips the step, as a
        # kernel that lost it would) must be far outside the y row limit.
        # The final state has forgotten the step by t = s (checks.py).
        x, dt, A, B, C, D, state = args
        half = shape[1] // 2
        with torch.inference_mode():
            dt_drop = dt.clone()
            dt_drop[:, half] = 0
            y_drop, h_drop = selective_scan_ref(x, dt_drop, A, B, C, D, state)
            lost, h_lost = row_err(y_drop, y_ref), row_err(h_drop, h_ref)
            del dt_drop, y_drop, h_drop
        print(f"[kernels] selective_scan main-path: the update at t = "
              f"{half} dropped gives worst row rel err {lost:.3e} in y "
              f"(limit {rtol:g}) and {h_lost:.3e} in the final state")
        check(lost > 10 * rtol, f"a dropped update gives only {lost:.3e}: "
                                f"the check cannot see it")
        with torch.inference_mode():
            ms = time_ms(lambda: scan_ops.selective_scan(*args))
            plain_ms = time_ms(lambda: selective_scan_ref(*args), iters=2,
                               warmup=1)
        bound_ms, bound_by, count = scan_bound(shape, dtype)
        print(f"[kernels] selective_scan main-path: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, no library call, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {json.dumps(count)})")
        entry = {
            "name": "selective_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/"
                      "selective_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan/kernel.py:51",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        }
        del args, y, h, y_ref, h_ref
    torch.cuda.empty_cache()
    return entry


class StepProbe:
    """Wraps a model: counts non-finite logits of every step and times
    each step on the host clock, up to the card finishing it."""

    def __init__(self, model):
        self.model = model
        self.reset()

    def reset(self):
        self.nonfinite = 0
        self.seconds = {"prefill": [], "decode": []}

    def _timed(self, kind, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.nonfinite += int((~torch.isfinite(out[0])).sum())   # syncs
        self.seconds[kind].append(time.perf_counter() - t0)
        return out

    def prefill(self, params, tokens, max_len):
        return self._timed("prefill", self.model.prefill, params, tokens,
                           max_len)

    def decode(self, params, cache, tokens, length):
        return self._timed("decode", self.model.decode, params, cache,
                           tokens, length)


def phase_main_path(arch, card, profile):
    """Serves ``arch``'s smoke traffic; returns each kernel's launches in
    that run (counts set to 0 just before it, read just after)."""
    from repro_torch.configs import get_config
    from repro_torch.core import (BatchSystem, Invoker, Ledger,
                                  ResourceManager)
    from repro_torch.models.factory import build_model
    from repro_torch.serving import ModelServer, ServeEngine

    ops = kernel_ops()
    n_req, batch, new_tokens, max_len = 8, 4, 16, 2048
    published = get_config(arch)
    cfg = published.replace(**PATH_CUTS.get(arch, {}))
    if cfg != published:
        print(f"[main] {arch} cut in depth, every width as published: "
              f"{PATH_CUTS[arch]} ({published.n_layers} layers, "
              f"{published.param_counts()['total'] / 1e9:.2f} B params "
              f"published; {cfg.param_counts()['total'] / 1e9:.2f} B in "
              f"the cut)")
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in _leaves(params))
    params_gb = sum(t.numel() * t.element_size()
                    for t in _leaves(params)) / 1e9
    print(f"[main] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.2f} B params ({params_gb:.2f} GB) in "
          f"{str(model.dtype)[6:]} initialised in {init_s:.1f} s, init "
          f"peak {init_peak_gb:.2f} GB")
    probe = StepProbe(model)
    server = ModelServer(probe, params, max_len=max_len)
    ledger = Ledger()
    rm = ResourceManager(n_replicas=2)
    cluster = BatchSystem(rm, ledger, n_nodes=2, workers_per_node=2,
                          hot_period=10.0)
    cluster.release_idle()
    rm.start_heartbeats()
    invoker = Invoker("serve", rm, server.make_library(), seed=SEED)
    try:
        check(invoker.allocate(1) == 1, "no worker leased")
        # warm-up wave (cuBLAS handles, first launches) off the record
        warm = ServeEngine(invoker, batch_size=1)
        warm.enqueue(np.arange(1, 33), max_new_tokens=2)
        warm.run()

        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(1, cfg.vocab_size,
                                size=int(rng.integers(256, 1025)))
                   for _ in range(n_req)]
        engine = ServeEngine(invoker, batch_size=batch)
        for p in prompts:
            engine.enqueue(p, max_new_tokens=new_tokens)
        probe.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in ops.values():
            mod.launches = 0
        flash_variants = ops["flash_attention"].launches_by_variant
        for variant in flash_variants:
            flash_variants[variant] = 0
        done = engine.run()
        launches = {name: mod.launches for name, mod in ops.items()}
        launches["flash_attention_by_variant"] = dict(flash_variants)
        m = engine.metrics()
    finally:
        invoker.deallocate()
        rm.stop()
    waves = -(-n_req // batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cache_gb = sum(t.numel() * t.element_size() for t in _leaves(
        model.init_cache(batch, max_len, "meta"))) / 1e9
    prefill_ms = [t * 1e3 for t in probe.seconds["prefill"]]
    decode_ms = float(np.median(probe.seconds["decode"])) * 1e3
    print(f"[main] prompts {[len(p) for p in prompts]}, {waves} waves; "
          f"kernel launches {launches}; "
          f"{len(probe.seconds['decode'])} decode steps; "
          f"{probe.nonfinite} non-finite logits")
    print(f"[main] step times on the host clock: prefill per wave "
          f"{[round(t, 1) for t in prefill_ms]} ms, decode step median "
          f"{decode_ms:.1f} ms")
    check(len(done) == n_req, f"{len(done)} of {n_req} requests served")
    check(all(len(r.tokens_out) == new_tokens for r in done),
          "a request got the wrong number of tokens")
    check(probe.nonfinite == 0, f"{probe.nonfinite} non-finite logits")
    want = {name: MAIN_PATHS[arch].get(name, 0) * waves for name in ops}
    # every K1 launch of a main path takes the Hopper variant
    want["flash_attention_by_variant"] = {
        "hopper": want["flash_attention"], "general": 0}
    check(launches == want, f"kernel launches {launches}, expected {want}")
    max_latency = max(r.latency for r in done)
    result = {
        "arch": arch, "requests": m["requests"], "tokens": m["tokens"],
        "throughput_tok_s": m["throughput_tok_s"],
        "p50_ttft_s": m["p50_ttft_s"], "p50_latency_s": m["p50_latency_s"],
        "p99_latency_s": m["p99_latency_s"], "max_latency_s": max_latency,
        "peak_memory_gb": peak_gb, "init_peak_memory_gb": init_peak_gb,
        "init_s": init_s, "params_gb": params_gb,
        "prefill_ms": prefill_ms, "decode_step_ms_median": decode_ms,
        "cache_gb": cache_gb, "bill_invocations":
            ledger.bill("serve").invocations, "card": card,
    }
    # 8 requests in 2 waves: a smoke of the path, not a serving
    # measurement; of 8 latencies the maximum is reported, not a p99.
    print(f"[main] smoke of {n_req} requests in {waves} waves: "
          f"{m['tokens']} tokens, {m['throughput_tok_s']:.2f} tok/s, "
          f"p50 TTFT {m['p50_ttft_s'] * 1e3:.1f} ms, p50 latency "
          f"{m['p50_latency_s'] * 1e3:.1f} ms, max latency "
          f"{max_latency * 1e3:.1f} ms, peak memory {peak_gb:.2f} GB "
          f"serving, {init_peak_gb:.2f} GB at init, cache {cache_gb:.3f} "
          f"GB | {card}")
    print("main_path " + json.dumps(result))
    if profile:
        profile_steps(model, params, max_len)
    return launches


def free_device_memory(what):
    """Frees what the previous phase left: the serving stack holds the
    model's params in reference cycles (server, library, invoker), which
    only the cycle collector breaks.  Fails if more than 1 GB is still
    allocated, so the next model's peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"[memory] after {what}: {left / 1e9:.3f} GB still allocated")
    check(left < 1e9, f"{left / 1e9:.2f} GB still allocated after {what}")


def profile_steps(model, params, max_len, batch=4, seq=1024, steps=3):
    """Where a step's time goes: one prefill wave (batch x seq) and
    ``steps`` decode steps, each timed on the host clock without the
    profiler, then run again under torch.profiler for the device time of
    its kernels (the kernels alone, not the host-side ops that launched
    them).  Prints, per step, the wall time, the kernel time and launches,
    the device-busy share (kernel time over wall time) and the kernels
    that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    toks = torch.randint(1, model.cfg.vocab_size, (batch, seq),
                         generator=gen, device="cuda")
    with torch.inference_mode():
        _, cache, length = model.prefill(params, toks, max_len)   # warm
        nxt = toks[:, -1:]
        model.decode(params, cache, nxt, length)

        def run_decode():
            for i in range(steps):
                model.decode(params, cache, nxt, length + 1 + i)

        runs = {"prefill": (1, seq, lambda: model.prefill(params, toks,
                                                          max_len)),
                "decode": (steps, 1, run_decode)}
        for kind, (n, tokens, run) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            if not kernels:
                print(f"[profile] {kind}: wall {wall_ms:.1f} ms per step; "
                      f"device time not measured (no CUDA events)")
                continue
            busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
            n_launch = sum(e.count for e in kernels) // n
            print(f"[profile] {kind} ({batch} x {tokens} tokens): wall "
                  f"{wall_ms:.1f} ms per step, kernels {busy_ms:.1f} ms in "
                  f"{n_launch} launches, device busy "
                  f"{100 * busy_ms / wall_ms:.0f}%")
            for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                            reverse=True)[:8]:
                print(f"[profile]   {e.self_device_time_total / 1e3 / n:8.2f}"
                      f" ms {e.count // n:5d}x  {e.key[:90]}")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def full_logits(model, params, toks):
    """Logits at every position from one forward over the whole
    sequence: cache-free for the dense and Jamba models (Jamba's Mamba
    layers from a zero state, through K3); for RWKV the same layers
    prefill runs (the kernel for the whole sequence), every position
    kept."""
    from repro_torch.models import common as C
    from repro_torch.models import layers as L
    from repro_torch.models.rwkv_lm import RWKVLM
    cfg = model.cfg
    if isinstance(model, RWKVLM):
        x = model._embed(params, toks)
        x = model._run_layers(x, params, model.init_cache(
            toks.shape[0], 0, toks.device))
    else:
        x = C.embed(toks, params["embed"], cfg)
        pos = torch.arange(toks.shape[1], device=toks.device)[None, :]
        x = model._run_layers(x, params, pos, None, None, "train")
    return C.lm_logits(L.apply_norm(x, params["final_norm"], cfg),
                       params["embed"], cfg)


def phase_decode_vs_prefill(arch):
    """Teacher-forced decode reproduces the logits of one forward over the
    whole sequence.  f32 at 1e-3: both paths are f32 (TF32 off) but
    reduce over the model's widths in different orders (a CUDA kernel
    against plain torch: attention, or the recurrence's step path)."""
    from repro_torch.configs import get_config
    from repro_torch.models.factory import build_model

    cfg = get_config(arch).replace(dtype="float32", **DECODE_CUTS[arch])
    if cfg.moe is not None:           # no drops on either side
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=16.0))
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = model.init(gen, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, 12), generator=gen,
                         device="cuda")
    tol, worst = 1e-3, 0.0
    with torch.inference_mode():
        ref = full_logits(model, params, toks)
        logits, cache, length = model.prefill(params, toks[:, :6], 16)
        got = [(logits[:, 0], ref[:, 5])]
        for i in range(6, 11):
            logits, cache, length = model.decode(params, cache,
                                                 toks[:, i:i + 1], length)
            got.append((logits[:, 0], ref[:, i]))
        for a, b in got:
            worst = max(worst, (a - b).abs().max().item())
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    print(f"[decode] {arch} {DECODE_CUTS[arch]} f32 full width: "
          f"teacher-forced decode vs one forward over 6 positions, "
          f"max_abs_err {worst:.3e} (tol {tol:g})")
    del params, cache
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after each main path, profile one prefill wave "
                         "and three decode steps with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's sources are not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    # f32 products in full f32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(card)
    phase_build()
    entries = {"flash_attention": phase_flash(), "wkv6": phase_wkv6(),
               "selective_scan": phase_scan()}
    check(all(entries.values()), "no main-path kernel measurement")
    for entry in entries.values():
        entry["launches"], entry["launches_by_path"] = 0, {}
    flash = entries["flash_attention"]
    flash["launches_by_variant"] = {"hopper": 0, "general": 0}
    for arch, per_wave in MAIN_PATHS.items():
        free_device_memory("the previous phase")
        launches = phase_main_path(arch, card, args.profile)
        for name in per_wave:
            entries[name]["launches"] += launches[name]
            entries[name]["launches_by_path"][arch] = launches[name]
        for variant, n in launches["flash_attention_by_variant"].items():
            flash["launches_by_variant"][variant] += n
    for arch in MAIN_PATHS:
        free_device_memory("the previous phase")
        phase_decode_vs_prefill(arch)
    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
