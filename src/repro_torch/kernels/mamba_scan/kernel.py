"""The Mamba selective scan (S6) as a hand-written CUDA kernel for Hopper
(sm_90a).

Replaces ``selective_scan_pallas`` (body ``_kernel``) in
``src/repro/kernels/mamba_scan/kernel.py``: for each (batch, channel),
``h_t = exp(Δ_t·A)·h_{t-1} + (Δ_t·x_t)·B_t`` and ``y_t = h_t·C_t + D·x_t``
with the N-entry state in f32.  The source is ``csrc/selective_scan.cu``.

What bounds it on an H100 at the main-path shape.  Prefill of the
Jamba-1.5-Large cut calls it once per Mamba layer with x (4, <=1024,
16384) in bf16, dt in f32 and N = 16.  One call reads x (134 MB), dt
(268 MB) and the state (4 MB) and writes y (134 MB) and the state: 545
MB, 0.163 ms at 3.35 TB/s.  It needs one exponential per state entry and
step, 1.07e9, at 16 a clock per SM: 0.257 ms at 1.98 GHz, and about 6.6
GFLOP of f32 FMAs and multiplies, 0.099 ms.  So the exponentials bound
it, and a MUFU.EX2 holds its warp scheduler about 4 clocks, so the
dispatch slots take about as long (the design's floor, 0.266 ms, PERF.md).
What the design does: one thread per (batch, channel) keeps the
channel's state and its row of A (scaled by log2 e) in registers for the
whole sequence; each exponential is one ``ex2.approx.ftz`` on the SFU; a
block of 128 channels copies the next chunk of x and dt into a second
shared-memory buffer with cp.async while it scans the current one.

Training mode (``checkpoints``): the "pipe" kernel also stores the state
before every ``CK_STEPS``-th step into a (b, ceil(s / CK_STEPS), di,
padded N) f32 tensor, with the instructions it scans with: the
checkpoints from which the backward (``kernel_bwd``) recomputes the
forward's states bit for bit.  y and the final state are those of
serving mode, bit for bit.

The designs, by kind: "pipe" is that kernel, ``DESIGN``, the one
``ops.selective_scan`` launches and the only one the serving library
holds; "first" is the kernel's first design (exp2f, one buffer, two
barriers a chunk), the yardstick, and "first-ex2" the same with
ex2.approx.  The sweep library (``sweep=True``, built with
``-DSCAN_SWEEP``) holds all three and a probe of the SFUs' ex2 rate,
and only ``chip_smoke.py`` and the card tests build it.  Measured times
stand in PERF.md.

The library is built at first use with nvcc (``kernels/_build.py``) into
``build/repro_torch/`` at the repository root, keyed by a hash of the
source, and loaded with ctypes.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "selective_scan"
SWEEP_NAME = "selective_scan_sweep"
SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
MAX_STATE = 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHANNELS = 128                # channels per block
CHUNK = 32                    # steps a chunk of the "pipe" kernel
CK_STEPS = 16                 # steps a checkpoint of the training mode
KINDS = {"first": 0, "first-ex2": 1, "pipe": 2}
# the design ops.selective_scan launches, the serving library's only one
DESIGN = "pipe"
# timed by chip_smoke.py at the main-path shape, in this order: the
# yardstick, then ex2.approx, then the design
CANDIDATES = ("first", "first-ex2", "pipe")
# (FFMAs beside each ex2, LDS.128 per 8 ex2) of the ex2 probe's
# instantiations in the sweep library (csrc/selective_scan.cu,
# SCAN_PROBES): the SFUs alone, and with the FMA pipe beside them
PROBES = ((0, 0), (8, 0))


def fits(design: str, sweep: bool = False) -> bool:
    """Whether the library (the sweep library if ``sweep``) holds
    ``design``."""
    return design == DESIGN or (sweep and design in KINDS)


def padded_state(n: int) -> int:
    """The state size the kernel runs at: 4, 8 or 16."""
    if n > MAX_STATE:
        raise ValueError(f"state size {n} > {MAX_STATE}")
    return 4 if n <= 4 else 8 if n <= 8 else 16


def smem_bytes(dtype, n: int) -> int:
    """Dynamic shared memory of a "pipe" block: two buffers, each of
    ``CHUNK`` rows of 128 channels of x (in ``dtype``) and dt (f32), and
    of ``CHUNK`` steps of B_t and C_t (f32, padded to the kernel's state
    size)."""
    size = torch.finfo(dtype).bits // 8
    return 2 * CHUNK * (CHANNELS * (size + 4) + 2 * padded_state(n) * 4)


def copy_width(t: torch.Tensor) -> int:
    """Bytes per cp.async unit for a (b, s, di) tensor whose last dim has
    stride 1: the largest of 16, 8, 4 that divides its address and its
    batch and step strides in bytes; 2 for a bf16 tensor that 4 does not
    divide (copied by plain loads).  A block's first channel is a
    multiple of 128, so its offset never lowers the width."""
    size = t.element_size()
    parts = [t.data_ptr()] + [t.stride(i) * size for i in range(2)]
    for width in (16, 8, 4, 2):
        if width >= size and all(v % width == 0 for v in parts):
            return width
    raise ValueError(f"no copy width for a {t.dtype} tensor at "
                     f"{t.data_ptr():#x} with strides {t.stride()}")


def _name(sweep: bool) -> str:
    return SWEEP_NAME if sweep else NAME


def library_path(sweep: bool = False) -> Path:
    return _build.library_path(SOURCE, _name(sweep))


def build(sweep: bool = False) -> Path:
    """Compiles the source (with the yardstick designs and the ex2 probe if
    ``sweep``) unless a library of the same source hash is already
    built."""
    return _build.build(SOURCE, _name(sweep),
                        ("-DSCAN_SWEEP",) if sweep else ())


@functools.lru_cache(maxsize=None)
def library(sweep: bool = False):
    lib = ctypes.CDLL(str(build(sweep)))
    fn = lib.selective_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    if sweep:
        probe = lib.ex2_rate_probe
        probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        probe.restype = ctypes.c_int
    return lib


def checkpoint_shape(shape):
    """The training mode's checkpoints for x of ``shape`` (b, s, di) and
    state size N: (b, ceil(s / CK_STEPS), di, padded N) f32."""
    b, s, di, n = shape
    return (b, -(-s // CK_STEPS), di, padded_state(n))


def selective_scan_cuda(x, dt, A, B, C, D, state, design=DESIGN,
                        sweep=False, checkpoints=None):
    """Launches ``design`` on the current stream, from the sweep library
    if ``sweep``.  x (b, s, di) and B, C (b, s, N) in one dtype, dt (b, s,
    di) f32, each with a last dim of stride 1; A (di, N), D (di,) and
    state (b, di, N) contiguous f32; the caller has checked them.  With
    ``checkpoints``, a contiguous f32 tensor of ``checkpoint_shape`` on
    x's device, ``DESIGN`` runs in training mode and fills it.  Returns (y
    (b, s, di) in x.dtype, final state (b, di, N) f32)."""
    if not fits(design, sweep):
        raise ValueError(f"no selective_scan design {design!r}"
                         + ("" if sweep else " in the serving library"))
    b, s, di = x.shape
    n = A.shape[1]
    if checkpoints is not None:
        want = checkpoint_shape((b, s, di, n))
        if (design != DESIGN or tuple(checkpoints.shape) != want
                or checkpoints.dtype != torch.float32
                or not checkpoints.is_contiguous()
                or checkpoints.device != x.device):
            raise ValueError(
                f"the training mode takes design {DESIGN!r} and contiguous "
                f"f32 checkpoints {want} on {x.device}; got {design!r}, "
                f"{tuple(checkpoints.shape)} {checkpoints.dtype} "
                f"{checkpoints.device}")
    y = torch.empty((b, s, di), dtype=x.dtype, device=x.device)
    h_out = torch.empty_like(state)
    strides = (ctypes.c_longlong * 8)(
        *(t.stride(i) for t in (x, dt, B, C) for i in range(2)))
    with torch.cuda.device(x.device):
        err = library(sweep).selective_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), state.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), DTYPES[x.dtype], b, s, di, n, strides,
            KINDS[design], copy_width(x), copy_width(dt),
            None if checkpoints is None else checkpoints.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_fwd launch failed: CUDA error "
                           f"{err}")
    return y, h_out


def ex2_rate(iters: int = 4096, block: int = 1024, fmas: int = 0,
             lds: int = 0) -> dict:
    """Measures the SFUs' ex2.approx rate with the sweep library's probe:
    one block of ``block`` threads on every SM (shared memory enough
    that an SM holds one), each thread 8 independent chains of ``iters``
    ex2 each, with ``fmas`` independent FFMAs beside each ex2 and ``lds``
    broadcast LDS.128 per 8 ex2 (a pair of ``PROBES``).  Returns the rate
    per SM per clock (from each SM's own cycle counter, the SMs' mean),
    the clock over the loop (the slowest SM's cycles over the event
    time) and the total rate."""
    if (fmas, lds) not in PROBES:
        raise ValueError(f"no ex2 probe with {fmas} FFMAs and {lds} LDS")
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * block, dtype=torch.float32, device=dev)
    cycles = torch.empty(sms, dtype=torch.int64, device=dev)
    sm = torch.empty(sms, dtype=torch.int32, device=dev)
    smem = 160 * 1024
    probe = library(True).ex2_rate_probe
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = probe(out.data_ptr(), cycles.data_ptr(), sm.data_ptr(), sms,
                    block, iters, smem, fmas, lds, stream)
        if err != 0:
            raise RuntimeError(f"ex2_rate_probe launch failed: CUDA error "
                               f"{err}")

    launch()                                   # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    per_block = block * iters * 8
    cyc = cycles.double()
    return {"sms": sms, "distinct_sms": int(sm.unique().numel()),
            "per_sm_per_clock": float((per_block / cyc).mean()),
            "clock_ghz": cyc.max().item() / ms / 1e6, "ms": ms,
            "per_s": sms * per_block / (ms * 1e-3),
            "finite": bool(torch.isfinite(out).all())}
