"""The WKV6 recurrence as a hand-written CUDA kernel for Hopper (sm_90a).

Replaces ``wkv6_pallas`` (body ``_kernel``) in
``src/repro/kernels/rwkv6/kernel.py``: for each (batch, head),
``y_t = r_t·(S + diag(u)·k_tᵀv_t)`` and ``S ← diag(w_t)·S + k_tᵀv_t``,
with the (hd, hd) state in f32.  The source is ``csrc/wkv6.cu``.

What bounds it on an H100 at the main-path shape.  Prefill of rwkv6-1.6b
calls it once per layer with r/k/v (4, <=1024, 32, 64) in bf16 and the
decay w in f32.  One call reads r, k, v (50 MB), w (34 MB) and the state
(2 MB) and writes y (17 MB) and the state (2 MB): 105 MB, 31 us at
3.35 TB/s.  It needs 4·hd² + 5·hd f32 operations per (batch, head,
step), with the state kept scaled by the running product of the decays
so that its update is one FMA per entry: 2.19 GFLOP, 33 us at 67
TFLOP/s.  What actually bounds it is latency: the
steps of a head form a dependent chain of 1024, and there are only 128
(batch, head) chains, one block each, so each SM runs two warps.  What
the design does about it: the state stays in registers for the whole
sequence (one thread per state column), a chunk of steps is staged in
shared memory per barrier, and the rank-1 ``u`` term is reduced once per
step with warp shuffles.  Measured times stand in PERF.md.

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

NAME = "wkv6"
SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
MAX_HEAD_DIM = 64
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
    fn = lib.wkv6_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def wkv6_cuda(r, k, v, w, u, state):
    """Launches the kernel on the current stream.  r/k/v (b, s, H, hd) in
    one dtype, w (b, s, H, hd) f32, u (H, hd) and state (b, H, hd, hd)
    contiguous f32; the caller has checked them.  Returns (y (b, s, H,
    hd) in r.dtype, final state (b, H, hd, hd) f32)."""
    b, s, h, hd = r.shape
    y = torch.empty((b, s, h, hd), dtype=r.dtype, device=r.device)
    s_out = torch.empty_like(state)
    strides = (ctypes.c_longlong * 15)(
        *(t.stride(i) for t in (r, k, v, w, y) for i in range(3)))
    with torch.cuda.device(r.device):
        err = library()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            DTYPES[r.dtype], b, s, h, hd, strides,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: CUDA error {err}")
    return y, s_out
