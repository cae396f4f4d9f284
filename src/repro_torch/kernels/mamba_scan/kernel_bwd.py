"""The selective scan's backward on the card: dx, ddt, dA, dB, dC, dD and
the initial state's gradient of the forward in ``kernel.py``, from the
CUDA C++ kernels of ``csrc/selective_scan_bwd.cu`` (sm_90a).

The TPU side has no backward kernel: the reference trains Jamba through
``jax.vjp`` of ``selective_scan_chunked`` (``src/repro/kernels/
mamba_scan/ops.py``), the jnp twin of ``selective_scan_pallas``.  The
port's Mamba layers go through K3, so its gradient runs on the card.  Its
plain version is ``ref.selective_scan_bwd_ref``.  A call launches three
kernels (``KERNELS``):

* "ckpt": the forward scan again, with the forward kernel's exponential
  and update, storing the state before every ``CK_STEPS``-th step into a
  scratch of ``checkpoint_shape``;
* "bwd": one reverse pass.  Four lanes hold a channel (``LANES``), N/4
  state entries each, so a sub-chunk's ``CK_STEPS`` states stay in
  registers: each sub-chunk, last first, is recomputed from its
  checkpoint and walked back with g = dL/dh.  It writes dx and ddt, dA
  and dD per batch, dh_0, and dB and dC as per-block partial sums over
  the block's ``CHANNELS`` channels (``partials_shape``);
* "sum": dB and dC, the block partials summed in order.

dA and dD are summed over the batch with a torch reduction.  No
atomics: two calls give the same bits.

What bounds it on an H100 at the training shape (4, 2048, 16384, N = 16)
in bf16: x, dt, dy read and dx, ddt written, 1.9 GB, 0.56 ms at 3.35
TB/s; its 2.15e9 exponentials take 0.51 ms on the SFUs.
``chip_smoke.py::scan_bwd_bound`` prints it; measured times stand in
PERF.md.

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
from repro_torch.kernels.mamba_scan.kernel import (DTYPES, MAX_STATE,
                                                   padded_state)

NAME = "selective_scan_bwd"
SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan_bwd.cu"
# the kernels a call launches, in order, and their bits in the entry's
# ``which``
KERNELS = ("ckpt", "bwd", "sum")
WHICH = {"ckpt": 1, "bwd": 2, "sum": 4}
# the source's layout constants
CK_STEPS = 16           # steps between checkpoints, and a sub-chunk
CHANNELS = 64           # channels a block
LANES = 4               # lanes a channel


def checkpoint_shape(shape):
    """The "ckpt" kernel's scratch for x of ``shape`` (b, s, di) and state
    size N: (b, ceil(s / CK_STEPS), di, padded N) f32."""
    b, s, di, n = shape
    return (b, -(-s // CK_STEPS), di, padded_state(n))


def partials_shape(shape):
    """dB's and dC's per-block partial sums: (b, s, ceil(di / CHANNELS),
    2 x padded N) f32."""
    b, s, di, n = shape
    return (b, s, -(-di // CHANNELS), 2 * padded_state(n))


def build() -> Path:
    """Compiles the source unless a library of the same source hash is
    already built."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def library():
    lib = ctypes.CDLL(str(build()))
    fn = lib.selective_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(x, dt, A, B, C, D, state, dy, dstate):
    b, s, di = x.shape
    n = A.shape[1]
    ok = (x.device.type == "cuda" and x.dtype in DTYPES
          and all(t.device == x.device
                  for t in (dt, A, B, C, D, state, dy))
          and all(t.dtype == x.dtype for t in (B, C, dy))
          and all(t.dtype == torch.float32 for t in (dt, A, D, state))
          and dt.shape == x.shape and dy.shape == x.shape
          and tuple(B.shape) == (b, s, n) and tuple(C.shape) == (b, s, n)
          and tuple(A.shape) == (di, n) and tuple(D.shape) == (di,)
          and tuple(state.shape) == (b, di, n)
          and all(t.stride(2) == 1 for t in (x, dt, B, C, dy))
          and all(t.is_contiguous() for t in (A, D, state))
          and 1 <= n <= MAX_STATE and s >= 1 and 1 <= b <= 65535
          and (dstate is None or (dstate.device == x.device
                                  and dstate.dtype == torch.float32
                                  and dstate.is_contiguous()
                                  and dstate.shape == state.shape)))
    if not ok:
        raise ValueError(
            f"selective_scan_bwd takes x, dy (b, s, di) and B, C (b, s, N <= "
            f"{MAX_STATE}) of one dtype of {list(DTYPES)}, dt (b, s, di) f32, "
            f"each with a last dim of stride 1; A (di, N), D (di,), state "
            f"and dstate (b, di, N) contiguous f32; one CUDA device; got "
            f"{[(tuple(t.shape), t.dtype, t.device.type) for t in (x, dt, A, B, C, D, state, dy)]}")


def selective_scan_bwd_cuda(x, dt, A, B, C, D, state, dy, dstate=None,
                            kernels=KERNELS):
    """Launches ``kernels`` (names of ``KERNELS``, all by default) on the
    current stream.  x, dy (b, s, di) and B, C (b, s, N) in one dtype of
    ``DTYPES`` and dt (b, s, di) f32, each with a last dim of stride 1; A
    (di, N), D (di,), state and ``dstate`` (b, di, N; None is zeros)
    contiguous f32.  Returns (dx (b, s, di) in x's dtype, ddt (b, s, di)
    f32, dA (di, N) f32, dB, dC (b, s, N) in x's dtype, dD (di,) f32,
    dstate_0 (b, di, N) f32), each contiguous; what a skipped kernel
    would have written is left unwritten.  Raises on a failed launch."""
    _check(x, dt, A, B, C, D, state, dy, dstate)
    if not kernels or not set(kernels) <= set(KERNELS):
        raise ValueError(f"selective_scan_bwd has kernels {KERNELS}, not "
                         f"{kernels}")
    b, s, di = x.shape
    n = A.shape[1]
    shape = (b, s, di, n)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    ck = torch.empty(checkpoint_shape(shape), **f32)
    dbc = torch.empty(partials_shape(shape), **f32)
    dx = torch.empty((b, s, di), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, di), **f32)
    dB = torch.empty((b, s, n), dtype=x.dtype, device=dev)
    dC = torch.empty((b, s, n), dtype=x.dtype, device=dev)
    dA = torch.empty((b, di, n), **f32)
    dD = torch.empty((b, di), **f32)
    dh0 = torch.empty((b, di, n), **f32)
    strides = (ctypes.c_longlong * 10)(
        *(t.stride(i) for t in (x, dt, B, C, dy) for i in range(2)))
    which = sum(WHICH[k] for k in set(kernels))
    with torch.cuda.device(dev):
        err = library().selective_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), state.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), ck.data_ptr(),
            dbc.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), dh0.data_ptr(),
            DTYPES[x.dtype], b, s, di, n, strides, which,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd launch failed: CUDA error "
                           f"{err}")
    return dx, ddt, dA.sum(0), dB, dC, dD.sum(0), dh0
