"""Flash attention's backward as hand-written CUDA kernels for Hopper
(sm_90a): dq, dk, dv of the forward in ``kernel.py``.

The TPU side has no backward kernel: the reference trains through the jnp
twin of ``flash_attention_pallas`` (``src/repro/models/attention.py::
flash_attention``), differentiated by JAX.  The port's attention goes
through K1, so its gradient is this kernel.  The source is
``csrc/flash_attention_bwd.cu``, a library of its own: the forward's
source and library stay as they are.

Three kernels a call, FlashAttention-2's deterministic schedule (no
atomics): (a) each row's log-sum-exp and D = rowsum(dO * o) per q tile;
(b) dK and dV per kv tile, walking the q tiles that see it; (c) dQ per q
tile, walking its kv tiles.  bf16 products on the tensor cores
(mma.sync), f32 through FMAs on the CUDA cores.

What bounds it on an H100 at the training shape, (4, 2048, 36, 64) bf16
causal (minicpm-2b): 5 products of 2 hd FLOPs per unmasked (query, key)
pair, 302.1 M pairs a call, 193.4 GFLOP, 0.196 ms at 989 TFLOP/s, above
its 302 MB of reads and writes (0.090 ms).  This first design loads its
tiles between barriers; measured times stand in PERF.md.

Built at first use with nvcc (``kernels/_build.py``) into
``build/repro_torch/``, keyed by a hash of the source, and loaded with
ctypes.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "flash_attention_bwd"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
MAX_HEAD_DIM = 128
# the kernels one call launches, in order
KERNELS = ("stats", "dkdv", "dq")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build() -> Path:
    """Compiles the source unless a library of the same source hash is
    already built."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def library():
    """The built library with its entry point typed."""
    lib = ctypes.CDLL(str(build()))
    lib.flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


def flash_attention_bwd_cuda(q, k, v, o, do, *, causal=True, window=0,
                             softcap=0.0):
    """Launches the three kernels on the current stream and returns (dq,
    dk, dv), contiguous, in the dtypes of q, k, v.  q/o/do are (b, sq, h,
    hd) and k/v (b, skv, h, hd) on one card, in one dtype of ``DTYPES``,
    hd at most ``MAX_HEAD_DIM``, head-dim stride 1; else it raises."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    tensors = (q, k, v, o, do)
    if (any(t.device != q.device or t.dtype != q.dtype
            or t.stride(3) != 1 for t in tensors)
            or q.device.type != "cuda" or q.dtype not in DTYPES
            or hd > MAX_HEAD_DIM or o.shape != q.shape
            or do.shape != q.shape or k.shape != (b, skv, h, hd)
            or v.shape != k.shape):
        raise ValueError(
            f"flash_attention_bwd takes q/o/do (b, sq, h, hd <= "
            f"{MAX_HEAD_DIM}), k/v (b, skv, h, hd), one CUDA device and "
            f"dtype of {list(DTYPES)}, head-dim stride 1; got "
            f"{[(tuple(t.shape), t.dtype, t.device.type) for t in tensors]}")
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    tensors = (*tensors, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(
        *(t.stride(i) for t in tensors for i in range(3)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().flash_attention_bwd(
            *(t.data_ptr() for t in tensors), lse.data_ptr(),
            delta.data_ptr(), DTYPES[q.dtype], b, sq, skv, h, hd, strides,
            1.0 / (hd ** 0.5), int(causal), int(window), float(softcap),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    return dq, dk, dv
