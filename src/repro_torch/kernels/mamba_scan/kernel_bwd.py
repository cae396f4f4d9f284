"""The selective scan's backward on the card: dx, ddt, dA, dB, dC, dD and
the initial state's gradient of the forward in ``kernel.py``, from the
CUDA C++ kernels of ``csrc/selective_scan_bwd.cu`` (sm_90a).

The TPU side has no backward kernel: the reference trains Jamba through
``jax.vjp`` of ``selective_scan_chunked`` (``src/repro/kernels/
mamba_scan/ops.py``), the jnp twin of ``selective_scan_pallas``.  The
port's Mamba layers go through K3, so its gradient runs on the card.  Its
plain version is ``ref.selective_scan_bwd_ref``.

The design (``DESIGN``, "pipe") reads the checkpoints that K3's forward
stores in training mode (``kernel.selective_scan_cuda(...,
checkpoints=)``: the state before every ``CK_STEPS``-th step) and
launches two kernels (``KERNELS``):

* "bwd": one reverse pass.  Four lanes hold a channel (``LANES``), N/4
  state entries each; each ``CK_STEPS``-step sub-chunk, last first, is
  recomputed from its checkpoint into registers and walked back with g =
  dL/dh, each decay formed again with the forward's instruction (keeping
  the recompute's decays in shared memory, one exponential an entry and
  step, was timed and is slower: PERF.md).  A lane holds its entries in
  an order of its own, so the reduce-scatter of dB and dC over a warp's
  channels needs no select.  cp.async stages the next sub-chunk (x, dt,
  dy, B, C and the checkpoints) while this one is walked back.  It
  writes dx and ddt, dA and dD per batch, dh_0, and dB and dC as
  per-block partial sums over the block's ``CHANNELS`` channels
  (``partials_shape``);
* "sum": dB and dC, the block partials summed in order.

dA and dD are summed over the batch with a torch reduction.  No
atomics: two calls give the same bits.

The sweep library (``sweep=True``, ``-DSCAN_BWD_SWEEP``) adds the first
design ("first", ``FIRST_KERNELS``), the yardstick: "ckpt" (the forward
scan again, storing the checkpoints), its own "bwd" (each decay formed
twice, a reduce-scatter with selects, staging between barriers) and
"sum".  Only ``chip_smoke.py``, the card tests and
``experiments/scan_bwd_knockouts_torch.py`` build it.

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
from repro_torch.kernels.mamba_scan import kernel
from repro_torch.kernels.mamba_scan.kernel import (DTYPES, MAX_STATE,
                                                   copy_width, padded_state)

NAME = "selective_scan_bwd"
SWEEP_NAME = "selective_scan_bwd_sweep"
SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan_bwd.cu"
# the design the training path launches, the only one of the library it
# loads, and the first design, the yardstick of the sweep library; the
# kernels a call of each launches, in order
DESIGN = "pipe"
KERNELS = ("bwd", "sum")
FIRST_KERNELS = ("ckpt", "bwd", "sum")
DESIGNS = {"pipe": KERNELS, "first": FIRST_KERNELS}
# each kernel's bit in the entry's ``which``
WHICH = {("pipe", "bwd"): 2, ("pipe", "sum"): 4, ("first", "ckpt"): 1,
         ("first", "bwd"): 8, ("first", "sum"): 4}
# the source's layout constants
CK_STEPS = kernel.CK_STEPS   # steps between checkpoints, and a sub-chunk
CHANNELS = 64                # channels a block
LANES = 4                    # lanes a channel
THREADS = CHANNELS * LANES
# the reverse pass's blocks an SM (its launch bound) and what that leaves
# a thread and a block on an H100
BLOCKS_PER_SM = 2
REGISTERS_PER_SM = 65536
SMEM_PER_SM = 233472         # bytes, of which each block reserves 1 KB
SMEM_PER_BLOCK = 232448      # the most a block may take


# the forward's training-mode checkpoints, the reverse pass's input
checkpoint_shape = kernel.checkpoint_shape


def partials_shape(shape):
    """dB's and dC's per-block partial sums: (b, s, ceil(di / CHANNELS),
    2 x padded N) f32."""
    b, s, di, n = shape
    return (b, s, -(-di // CHANNELS), 2 * padded_state(n))


def sub_chunks(s):
    """The reverse pass's sub-chunks of a sequence of ``s`` steps, in the
    order it walks them: (first step, steps before s) of each, last
    first; every sub-chunk runs ``CK_STEPS`` steps, those past s staged as
    zeros."""
    return [(t0, min(CK_STEPS, s - t0))
            for t0 in reversed(range(0, s, CK_STEPS))]


def registers_per_thread():
    """The registers a thread of the reverse pass may take at
    ``BLOCKS_PER_SM`` blocks of ``THREADS`` an SM (its launch bound)."""
    return REGISTERS_PER_SM // (BLOCKS_PER_SM * THREADS)


def stash_registers(n):
    """The registers a lane's recomputed states take at state size N: the
    K + 1 states h_{t0-1} .. h_{t0+K-1} of its N/4 entries."""
    return (CK_STEPS + 1) * padded_state(n) // LANES


def smem_bytes(dtype, n):
    """The reverse pass's dynamic shared memory a block: each warp's sums
    of each of K steps (f32: 2 x padded N of dB and dC, 16 of dx and
    ddt); the packed rows (dt, dt x, dy, x) f32 of K steps x 64 channels;
    B_t and C_t in each of the N/4 lane orders (f32, each order's K x
    padded N padded by 16 floats); the next sub-chunk's raw x, dy, B, C (in
    ``dtype``), dt (f32) and checkpoint quarters (f32)."""
    np_ = padded_state(n)
    nq = np_ // LANES
    size = torch.finfo(dtype).bits // 8
    k, ch = CK_STEPS, CHANNELS
    return (k * (THREADS // 32) * (2 * np_ + 16) * 4 + k * ch * 16
            + 2 * nq * (k * np_ + 16) * 4 + k * ch * (2 * size + 4)
            + 2 * k * np_ * size + THREADS * nq * 4)


def build(sweep: bool = False) -> Path:
    """Compiles the source (with the first design if ``sweep``) unless a
    library of the same source hash is already built."""
    return _build.build(SOURCE, SWEEP_NAME if sweep else NAME,
                        ("-DSCAN_BWD_SWEEP",) if sweep else ())


@functools.lru_cache(maxsize=None)
def library(sweep: bool = False):
    lib = ctypes.CDLL(str(build(sweep)))
    fn = lib.selective_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
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


def forward_checkpoints(x, dt, A, B, C, D, state):
    """K3's forward in training mode: the checkpoints the backward reads
    (y and the final state dropped)."""
    ck = torch.empty(checkpoint_shape((*x.shape, A.shape[1])),
                     dtype=torch.float32, device=x.device)
    kernel.selective_scan_cuda(x, dt, A, B, C, D, state, checkpoints=ck)
    return ck


def selective_scan_bwd_cuda(x, dt, A, B, C, D, state, dy, dstate=None,
                            kernels=None, checkpoints=None, design=DESIGN,
                            sweep=False):
    """Launches ``kernels`` of ``design`` (names of ``DESIGNS[design]``,
    all by default) on the current stream; the first design needs the
    sweep library (``sweep``).  x, dy (b, s, di) and B, C (b, s, N) in one
    dtype of ``DTYPES`` and dt (b, s, di) f32, each with a last dim of
    stride 1; A (di, N), D (di,), state and ``dstate`` (b, di, N; None is
    zeros) contiguous f32.  ``checkpoints`` (contiguous f32 of
    ``checkpoint_shape``): for "pipe" the forward's, or None to run the
    forward in training mode for them; for "first" the scratch its "ckpt"
    kernel writes (None: a new one).  Returns (dx (b, s, di) in x's dtype,
    ddt (b, s, di) f32, dA (di, N) f32, dB, dC (b, s, N) in x's dtype, dD
    (di,) f32, dstate_0 (b, di, N) f32), each contiguous; what a skipped
    kernel would have written is left unwritten.  Raises on a failed
    launch."""
    if design not in DESIGNS:
        raise ValueError(f"selective_scan_bwd has designs {list(DESIGNS)}, "
                         f"not {design!r}")
    if design != DESIGN and not sweep:
        raise ValueError(f"the design {design!r} is in the sweep library "
                         f"only")
    kernels = DESIGNS[design] if kernels is None else tuple(kernels)
    if not kernels or not set(kernels) <= set(DESIGNS[design]):
        raise ValueError(f"selective_scan_bwd {design!r} has kernels "
                         f"{DESIGNS[design]}, not {kernels}")
    _check(x, dt, A, B, C, D, state, dy, dstate)
    b, s, di = x.shape
    n = A.shape[1]
    shape = (b, s, di, n)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    if checkpoints is None:
        if design == DESIGN and "bwd" in kernels:
            checkpoints = forward_checkpoints(x, dt, A, B, C, D, state)
        else:
            checkpoints = torch.empty(checkpoint_shape(shape), **f32)
    elif (tuple(checkpoints.shape) != checkpoint_shape(shape)
          or checkpoints.dtype != torch.float32
          or not checkpoints.is_contiguous() or checkpoints.device != dev):
        raise ValueError(f"selective_scan_bwd takes contiguous f32 "
                         f"checkpoints {checkpoint_shape(shape)}; got "
                         f"{tuple(checkpoints.shape)} {checkpoints.dtype}")
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
    which = sum(WHICH[design, k] for k in set(kernels))
    with torch.cuda.device(dev):
        err = library(sweep).selective_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), state.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(),
            checkpoints.data_ptr(), dbc.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
            dD.data_ptr(), dh0.data_ptr(), DTYPES[x.dtype], b, s, di, n,
            strides, which, *(copy_width(t) for t in (x, dt, dy, B, C)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd launch failed: CUDA error "
                           f"{err}")
    return dx, ddt, dA.sum(0), dB, dC, dD.sum(0), dh0
