#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from a checkout of the repository; it needs one CUDA card and nothing
but the sources in the checkout.  Phases, in order; any failure exits
non-zero and prints no result:

1. device: require CUDA, print the card's name and power limit;
2. build: compile every kernel of the serving path with nvcc (sm_90a);
3. kernels: hold each kernel against its plain torch version on the card
   at the main-path shape and at edge shapes, elementwise and row by row,
   and time the kernel, the plain version and a PyTorch library call as
   a yardstick;
4. main path: mistral-nemo-12b at full width (40 layers, d_model 5120,
   bf16, seeded random weights) served through the port's rFaaS stack
   (ModelServer, ServeEngine, Invoker, ResourceManager, BatchSystem,
   Ledger): 8 requests, batch 4, prompts of 256-1024 tokens, 16 new tokens
   each, max_len 2048; checks that every request gets its tokens, every
   logit is finite and the flash kernel ran 40 times per prefill wave.
   With --profile, then one prefill wave and three decode steps outside
   the engine, timed and traced with torch.profiler;
5. decode vs prefill: a 2-layer full-width f32 mistral-nemo-12b,
   teacher-forced decode against a cache-free forward;
6. the kernels line, the card line and the result line, last.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
ARCH = "mistral-nemo-12b"
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,          # dense tensor cores
              torch.float32: 67e12}            # CUDA cores, no TF32
# Elementwise limit (atol = rtol).  f32: the kernel tests' 2e-5.  bf16:
# both sides round the output to bf16, and at |out| ~ 1-4 one bf16 ulp is
# 0.008-0.03, so an absolute 1e-2 plus 1e-2 of |ref|.
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# Limit on ||out - ref|| / ||ref|| of every (b, q, h) row.  bf16: the
# kernel rounds P to bf16 (relative 2^-9) and the output to bf16 (2^-9),
# so ~3e-3 at most.  A row that loses the key it attends to errs by O(1).
ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# name, (b, sq, skv, h, hd), dtype, causal, window, softcap, strided
FLASH_CASES = [
    ("main-path", (4, 1024, 1024, 32, 128), torch.bfloat16, True, 0, 0.0,
     False),
    ("window", (1, 257, 257, 4, 64), torch.float32, True, 64, 0.0, False),
    ("minicpm-hd12", (2, 100, 100, 6, 12), torch.float32, True, 0, 0.0,
     False),
    ("softcap-hd256", (1, 96, 96, 2, 256), torch.bfloat16, True, 0, 30.0,
     False),
    ("ragged-noncausal", (1, 64, 192, 2, 64), torch.float32, False, 0, 0.0,
     False),
    ("strided-gemma-hd16", (2, 130, 130, 4, 16), torch.float32, True, 16,
     0.0, True),
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


def phase_build():
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    t0 = time.perf_counter()
    so = flash_kernel.build()
    flash_kernel.library()
    dt = time.perf_counter() - t0
    print(f"[build] flash_attention -> {so.relative_to(ROOT)} in {dt:.1f} s")
    log = (so.parent / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


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


def phase_kernels():
    """Each case: kernel vs plain version, tolerance by dtype.  Returns
    the kernels-line entry (numbers at the main-path case)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entry = None
    for name, shape, dtype, causal, window, softcap, strided in FLASH_CASES:
        q, k, v = _flash_inputs(shape, dtype, strided, gen)
        kw = dict(causal=causal, window=window, softcap=softcap)
        with torch.inference_mode():
            out = flash_ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        rerr = row_err(out, ref)
        tol, rtol = TOL[dtype], ROW_TOL[dtype]
        print(f"[kernels] flash_attention {name} {tuple(shape)} "
              f"{str(dtype)[6:]} causal={causal} window={window} "
              f"softcap={softcap}: max_abs_err {err:.3e} (limit {tol:g} + "
              f"{tol:g} x |ref|), "
              f"worst row rel err {rerr:.3e} (tol {rtol:g})")
        check(math.isfinite(err), f"flash_attention {name}: non-finite")
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
        check(rerr <= rtol, f"flash_attention {name}: worst row rel err "
                            f"{rerr:.3e} > {rtol:g}")
        if name != "main-path":
            continue
        # The checks can fail here: the plain version with the values of
        # one middle kv tile zeroed (what a kernel that lost the tile
        # would return) must be far outside the row limit.
        with torch.inference_mode():
            v_lost = v.clone()
            v_lost[:, 512:576] = 0
            lost = row_err(attention_ref(q, k, v_lost, **kw), ref)
            del v_lost
        print(f"[kernels] flash_attention main-path: a lost kv tile "
              f"[512, 576) gives worst row rel err {lost:.3e}")
        check(lost > 10 * rtol, f"a lost kv tile gives only {lost:.3e}: "
                                f"the check cannot see it")
        with torch.inference_mode():
            ms = time_ms(lambda: flash_ops.flash_attention(q, k, v, **kw))
            plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), iters=3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
        bound_ms, bound_by = flash_bound(shape, dtype, causal, window)
        print(f"[kernels] flash_attention main-path: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        entry = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
        }
        del q, k, v, out, ref
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


def phase_main_path(card, profile):
    from repro_torch.configs import get_config
    from repro_torch.core import (BatchSystem, Invoker, Ledger,
                                  ResourceManager)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.factory import build_model
    from repro_torch.serving import ModelServer, ServeEngine

    n_req, batch, new_tokens, max_len = 8, 4, 16, 2048
    cfg = get_config(ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[main] {ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.2f} B params in {str(model.dtype)[6:]} "
          f"initialised in {time.perf_counter() - t0:.1f} s")
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
        flash_ops.launches = 0
        done = engine.run()
        launches = flash_ops.launches
        m = engine.metrics()
    finally:
        invoker.deallocate()
        rm.stop()
    waves = -(-n_req // batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cache_gb = (2 * cfg.n_layers * batch * max_len * cfg.n_kv_heads
                * cfg.resolved_head_dim * 2) / 1e9
    prefill_ms = [t * 1e3 for t in probe.seconds["prefill"]]
    decode_ms = float(np.median(probe.seconds["decode"])) * 1e3
    print(f"[main] prompts {[len(p) for p in prompts]}, {waves} waves; "
          f"flash_attention launches {launches}; "
          f"{len(probe.seconds['decode'])} decode steps; "
          f"{probe.nonfinite} non-finite logits")
    print(f"[main] step times on the host clock: prefill per wave "
          f"{[round(t, 1) for t in prefill_ms]} ms, decode step median "
          f"{decode_ms:.1f} ms")
    check(len(done) == n_req, f"{len(done)} of {n_req} requests served")
    check(all(len(r.tokens_out) == new_tokens for r in done),
          "a request got the wrong number of tokens")
    check(probe.nonfinite == 0, f"{probe.nonfinite} non-finite logits")
    check(launches == cfg.n_layers * waves,
          f"flash_attention launched {launches} times, expected "
          f"{cfg.n_layers * waves}")
    max_latency = max(r.latency for r in done)
    result = {
        "arch": ARCH, "requests": m["requests"], "tokens": m["tokens"],
        "throughput_tok_s": m["throughput_tok_s"],
        "p50_ttft_s": m["p50_ttft_s"], "p50_latency_s": m["p50_latency_s"],
        "p99_latency_s": m["p99_latency_s"], "max_latency_s": max_latency,
        "peak_memory_gb": peak_gb,
        "prefill_ms": prefill_ms, "decode_step_ms_median": decode_ms,
        "kv_cache_gb": cache_gb, "bill_invocations":
            ledger.bill("serve").invocations, "card": card,
    }
    # 8 requests in 2 waves: a smoke of the path, not a serving
    # measurement; the p99 of 8 latencies is all but their maximum.
    print(f"[main] smoke of {n_req} requests in {waves} waves: "
          f"{m['tokens']} tokens, {m['throughput_tok_s']:.2f} tok/s, "
          f"p50 TTFT {m['p50_ttft_s'] * 1e3:.1f} ms, p50 latency "
          f"{m['p50_latency_s'] * 1e3:.1f} ms, p99 latency "
          f"{m['p99_latency_s'] * 1e3:.1f} ms (max "
          f"{max_latency * 1e3:.1f} ms), peak memory {peak_gb:.2f} GB "
          f"| {card}")
    print("main_path " + json.dumps(result))
    if profile:
        profile_steps(model, params, max_len)
    del server, params, probe, model
    torch.cuda.empty_cache()
    return launches


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


def phase_decode_vs_prefill():
    """Teacher-forced decode reproduces a cache-free forward's logits.
    f32 at 1e-3: both paths are f32 (TF32 off) but reduce over 5120 and
    14336 terms in different orders (CUDA kernel vs plain torch)."""
    from repro_torch.configs import get_config
    from repro_torch.models import common as C
    from repro_torch.models import layers as L
    from repro_torch.models.factory import build_model

    cfg = get_config(ARCH).replace(n_layers=2, dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = model.init(gen, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, 12), generator=gen,
                         device="cuda")
    tol, worst = 1e-3, 0.0
    with torch.inference_mode():
        x = C.embed(toks, params["embed"], cfg)
        pos = torch.arange(12, device="cuda")[None, :]
        x = model._run_layers(x, params, pos, None, None, "train")
        ref = C.lm_logits(L.apply_norm(x, params["final_norm"], cfg),
                          params["embed"], cfg)
        logits, cache, length = model.prefill(params, toks[:, :6], 16)
        got = [(logits[:, 0], ref[:, 5])]
        for i in range(6, 11):
            logits, cache, length = model.decode(params, cache,
                                                 toks[:, i:i + 1], length)
            got.append((logits[:, 0], ref[:, i]))
        for a, b in got:
            worst = max(worst, (a - b).abs().max().item())
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    print(f"[decode] {ARCH} 2 layers f32 full width: teacher-forced decode "
          f"vs full forward over 6 positions, max_abs_err {worst:.3e} "
          f"(tol {tol:g})")
    del params, cache
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile one prefill wave "
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
    entry = phase_kernels()
    check(entry is not None, "no main-path kernel measurement")
    entry["launches"] = phase_main_path(card, args.profile)
    phase_decode_vs_prefill()
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
