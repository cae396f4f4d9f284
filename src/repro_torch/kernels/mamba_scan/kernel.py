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
step, 1.07e9, at 16 a clock per SM: 0.257 ms at 1.98 GHz, and about 6.4
GFLOP of f32 FMAs and multiplies, 0.096 ms.  So the exponentials bound
it.  What the design does: one thread per (batch, channel) keeps the
channel's state and its row of A (scaled by log2 e, so each exponential is
one ex2) in registers for the whole sequence, and a block of 128 channels
stages 32 steps of x, dt, B and C in shared memory per barrier.  65,536
independent chains keep about 16 warps on every SM.  Measured times
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
SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
MAX_STATE = 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def library_path() -> Path:
    return _build.library_path(SOURCE, NAME)


def build() -> Path:
    """Compiles the source unless a library of the same source hash is
    already built."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def library():
    lib = ctypes.CDLL(str(build()))
    fn = lib.selective_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def selective_scan_cuda(x, dt, A, B, C, D, state):
    """Launches the kernel on the current stream.  x (b, s, di) and B, C
    (b, s, N) in one dtype, dt (b, s, di) f32, each with a last dim of
    stride 1; A (di, N), D (di,) and state (b, di, N) contiguous f32; the
    caller has checked them.  Returns (y (b, s, di) in x.dtype, final
    state (b, di, N) f32)."""
    b, s, di = x.shape
    n = A.shape[1]
    y = torch.empty((b, s, di), dtype=x.dtype, device=x.device)
    h_out = torch.empty_like(state)
    strides = (ctypes.c_longlong * 8)(
        *(t.stride(i) for t in (x, dt, B, C) for i in range(2)))
    with torch.cuda.device(x.device):
        err = library()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), state.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), DTYPES[x.dtype], b, s, di, n, strides,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_fwd launch failed: CUDA error "
                           f"{err}")
    return y, h_out
