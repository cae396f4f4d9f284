"""Flash attention as a hand-written CUDA kernel for Hopper (sm_90a).

Replaces ``flash_attention_pallas`` (body ``_kernel``) in
``src/repro/kernels/flash_attention/kernel.py``: the same blockwise
online-softmax attention, on (b, s, h, hd) tensors with GQA heads already
repeated.  The source is ``csrc/flash_attention.cu``.

What bounds it on an H100 at the main-path shapes.  Prefill of
mistral-nemo-12b calls it with q/k/v (4, <=1024, 32, 128) in bf16, causal.
Each call reads q, k, v and writes o once: 4 x 32 MiB, about 40 us at
3.35 TB/s.  Its products are 4 x hd FLOPs per unmasked (query, key) pair,
34 GFLOP at s = 1024, about 35 us at the 989 TFLOP/s bf16 tensor-core
peak.  So the function is bound by bytes and by the tensor cores about
equally, and only tensor-core products can come near that bound.  What
the design does about it: bf16 inputs go through mma.sync tensor-core
products with f32 accumulators, the probabilities never leave registers
(the score fragments are reused as the next product's operand), tiles
above the causal diagonal or before the window are skipped (half the
work at s = 1024), tiles are loaded with 16-byte vector loads, and the
longest q tiles are scheduled first.  What it does not do yet: overlap
loads with products (cp.async/TMA), wgmma, warp specialisation.  f32
inputs (the parity checks, not the serving path) use f32 FMAs on the
CUDA cores (67 TFLOP/s), because TF32 would not meet f32's tolerance.
Measured times stand in PERF.md.

The library is built at first use with nvcc into ``build/repro_torch/`` at
the repository root, keyed by a hash of the source, and loaded with
ctypes.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_ROOT = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / f"flash_attention-{digest}" / "libflash_attention.so"


def build() -> Path:
    """Compiles the source unless a library of the same source hash is
    already built.  nvcc's output (ptxas register and spill counts) is
    kept beside the library as ``build.log``."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (so.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def library():
    lib = ctypes.CDLL(str(build()))
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Launches the kernel on the current stream and returns o (b, sq, h,
    hd) in q.dtype.  The caller has checked device, dtype and shapes."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    with torch.cuda.device(q.device):
        err = library()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            DTYPES[q.dtype], b, sq, skv, h, hd, strides,
            1.0 / (hd ** 0.5), int(causal), int(window), float(softcap),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    return o
