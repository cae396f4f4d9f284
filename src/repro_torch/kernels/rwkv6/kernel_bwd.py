"""WKV6's backward on the card: dr, dk, dv, dw, du and the initial
state's gradient of the forward in ``kernel.py``, from two kernels.

The TPU side has no backward kernel: the reference trains RWKV through
``wkv6_chunked`` (``src/repro/kernels/rwkv6/ops.py``), a jnp twin of
``wkv6_pallas`` that JAX differentiates.  The port's time mix goes
through K2, so its gradient runs on the card.  Its plain version is
``ref.wkv6_bwd_ref``.  A call launches (``KERNELS``):

* "bwd": the hand-written kernel of ``csrc/wkv6_bwd.cu`` (a library of
  its own), for dr, dk, dw and du.  Every row of the state and of its
  gradient G = dL/dS evolves on its own and these gradients contract
  within a row, so a block owns 16 rows of a (batch, head) and no block
  waits on another.  A forward pass recomputes the state from S_0,
  writes dr and stores the state every ``SUB_STEPS`` steps to a scratch
  buffer; a reverse pass recomputes each sub-chunk's states from its
  checkpoint into registers and walks it back with G for dk and dw.  dw
  takes S_{t-1} and G_t together, exactly, at any w in [0, 1] (the
  pair-sum identity would divide by w).  du comes back as per-(b, h)
  partial sums, summed over the batch with a torch reduction.
* "dv": K2's forward kernel (``kernel.py``'s serving library) run
  backward in time, for dv and dS_0.  G obeys the forward's recurrence
  in reverse, G_{t-1} = diag(w_t) G_t + r_tᵀ dy_t, and dv_t = G_tᵀ k_t +
  (Σ u r_t k_t) dy_t is the forward's output with r and k swapped and dy
  for v: the forward kernel, handed k, r, dy, w and dS_T as views that
  walk time from its end (negative time strides), writes dv in forward
  order and returns G_0 = dS_0 as its final state.

No atomics: two calls give the same bits.

What bounds it on an H100 at the training shape (4, 2048, 32, 64) bf16
(rwkv6-1.6b): its 375 MB of reads and writes take 0.11 ms at 3.35 TB/s;
its least arithmetic, 5 FMAs per state entry and step (10.7 GFLOP),
0.16 ms at 67 TFLOP/s of f32.  ``chip_smoke.py::wkv_bwd_bound`` prints it;
measured times stand in PERF.md.

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
from repro_torch.kernels.rwkv6 import kernel
from repro_torch.kernels.rwkv6.kernel import DTYPES, padded_head_dim

NAME = "wkv6_bwd"
SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6_bwd.cu"
MAX_HEAD_DIM = 64
# the kernels a call launches, in order
KERNELS = ("bwd", "dv")
SUB_STEPS = 16          # steps between checkpoints (the source's kSub)


def build() -> Path:
    """Compiles the source unless a library of the same source hash is
    already built."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def library():
    lib = ctypes.CDLL(str(build()))
    fn = lib.wkv6_bwd
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def checkpoint_shape(shape):
    """The scratch buffer of the states the forward pass stores, (b, H,
    ceil(s / SUB_STEPS), HDP, HDP) f32, for r of ``shape`` (b, s, H,
    hd)."""
    b, s, h, hd = shape
    hdp = padded_head_dim(hd)
    return (b, h, -(-s // SUB_STEPS), hdp, hdp)


def _check(r, k, v, w, u, state, dy, dstate):
    b, s, h, hd = r.shape
    ok = (r.device.type == "cuda" and r.dtype in DTYPES
          and all(t.device == r.device for t in (k, v, w, u, state, dy))
          and all(t.dtype == r.dtype and t.shape == r.shape
                  for t in (k, v, dy))
          and w.dtype == torch.float32 and w.shape == r.shape
          and all(t.stride(3) == 1 for t in (r, k, v, w, dy))
          and u.dtype == torch.float32 and u.is_contiguous()
          and tuple(u.shape) == (h, hd)
          and state.dtype == torch.float32 and state.is_contiguous()
          and tuple(state.shape) == (b, h, hd, hd)
          and 1 <= hd <= MAX_HEAD_DIM and s >= 1 and b <= 65535
          and (dstate is None or (dstate.device == r.device
                                  and dstate.dtype == torch.float32
                                  and dstate.is_contiguous()
                                  and dstate.shape == state.shape)))
    if not ok:
        raise ValueError(
            f"wkv6_bwd takes r/k/v/dy (b, s, H, hd <= {MAX_HEAD_DIM}) of one "
            f"dtype of {list(DTYPES)}, w of their shape in f32, head-dim "
            f"stride 1; u (H, hd), state and dstate (b, H, hd, hd) "
            f"contiguous f32; one CUDA device; got "
            f"{[(tuple(t.shape), t.dtype, t.device.type) for t in (r, k, v, w, u, state, dy)]}")


def _reversed(t):
    """(data pointer, (batch, seq, head) strides) of ``t`` (b, s, H, hd)
    walked from its last step: the pointer of step s - 1, the seq stride
    negated."""
    size = t.element_size()
    return (t.data_ptr() + (t.shape[1] - 1) * t.stride(1) * size,
            (t.stride(0), -t.stride(1), t.stride(2)))


def wkv6_bwd_cuda(r, k, v, w, u, state, dy, dstate=None, kernels=KERNELS):
    """Launches ``kernels`` (names of ``KERNELS``, all by default) on the
    current stream.  r/k/v/dy (b, s, H, hd) in one dtype of ``DTYPES``
    and w (b, s, H, hd) f32, each with head-dim stride 1; u (H, hd),
    state and ``dstate`` (b, H, hd, hd; None is zeros) contiguous f32.
    Returns (dr, dk, dv in r's dtype, dw f32 (b, s, H, hd), du (H, hd)
    f32, dstate_0 (b, H, hd, hd) f32), each contiguous; what a skipped
    kernel would have written is left unwritten.  Raises on a failed
    launch."""
    _check(r, k, v, w, u, state, dy, dstate)
    if not set(kernels) <= set(KERNELS):
        raise ValueError(f"wkv6_bwd has kernels {KERNELS}, not {kernels}")
    b, s, h, hd = r.shape
    dr, dk, dv = (torch.empty(r.shape, dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    du = torch.empty((b, h, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(state)
    ck = torch.empty(checkpoint_shape(r.shape), dtype=torch.float32,
                     device=r.device)
    g0 = torch.zeros_like(state) if dstate is None else dstate
    strides = (ctypes.c_longlong * 15)(
        *(t.stride(i) for t in (r, k, v, w, dy) for i in range(3)))
    # the forward kernel backward in time: r <- k, k <- r, v <- dy, y = dv
    rev = [_reversed(t) for t in (k, r, dy, w, dv)]
    rev_strides = (ctypes.c_longlong * 15)(*(x for _, st in rev for x in st))
    plan = kernel.plan(r.shape, r.dtype)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        if "bwd" in kernels:
            err = library()(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                dy.data_ptr(), u.data_ptr(), state.data_ptr(),
                None if dstate is None else dstate.data_ptr(),
                dr.data_ptr(), dk.data_ptr(), dw.data_ptr(), du.data_ptr(),
                ck.data_ptr(), DTYPES[r.dtype], b, s, h, hd, strides, stream)
            if err != 0:
                raise RuntimeError(f"wkv6_bwd launch failed: CUDA error "
                                   f"{err}")
        if "dv" in kernels:
            err = kernel.library()(
                *(ptr for ptr, _ in rev[:4]), u.data_ptr(), g0.data_ptr(),
                rev[4][0], ds0.data_ptr(), DTYPES[r.dtype], b, s, h, hd,
                rev_strides, *plan, kernel.chunk_steps(hd, r.dtype, plan), 1,
                stream)
            if err != 0:
                raise RuntimeError(f"wkv6_bwd's dv pass (wkv6_fwd) launch "
                                   f"failed: CUDA error {err}")
    return dr, dk, dv, dw, du.sum(0), ds0
