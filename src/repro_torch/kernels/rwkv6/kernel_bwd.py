"""WKV6's backward on the card: dr, dk, dv, dw, du and the initial
state's gradient of the forward in ``kernel.py``, from two kernels.

The TPU side has no backward kernel: the reference trains RWKV through
``wkv6_chunked`` (``src/repro/kernels/rwkv6/ops.py``), a jnp twin of
``wkv6_pallas`` that JAX differentiates.  The port's time mix goes
through K2, so its gradient runs on the card.  Its plain version is
``ref.wkv6_bwd_ref``.  A call launches (``KERNELS``):

* "bwd", from ``csrc/wkv6_bwd.cu`` (a library of its own), for dr, dk, dw
  and du, on one of two routes (``ROUTES``) that ``plan`` picks before
  the forward runs:

  - "hopper": hd 64, f32 or bf16, views TMA can read.  K2's forward in
    training mode has stored the state every ``PLAN[2]`` steps (the
    checkpoints); one reverse pass recomputes each sub-chunk's states
    from its checkpoint into registers, forming dr, then walks them back
    with G = dL/dS for dk and dw.  A block owns one (batch, head); each
    thread holds R rows x C columns of G and of the sub-chunk's states
    (``PLAN`` = (R, C, SUB)); a producer warp stages each sub-chunk with
    TMA into a 3-stage mbarrier ring and turns bf16 into f32.
  - "general": the first design, for every other call (head dims below 64,
    strides or offsets TMA refuses).  Blocks of 16 rows; a forward pass
    recomputes the state from S_0, writes dr and stores the state every
    ``SUB_STEPS`` steps to a scratch buffer; a reverse pass recomputes
    each sub-chunk's states from it.

  On both, dw takes S_{t-1} and G_t together, exactly, at any w in [0, 1]
  (the pair-sum identity would divide by w); du comes back as per-(b, h)
  partial sums, summed over the batch with a torch reduction.
* "dv": K2's forward kernel (``kernel.py``'s serving library) run
  backward in time, for dv and dS_0.  G obeys the forward's recurrence
  in reverse, G_{t-1} = diag(w_t) G_t + r_tᵀ dy_t, and dv_t = G_tᵀ k_t +
  (Σ u r_t k_t) dy_t is the forward's output with r and k swapped and dy
  for v: the forward kernel, handed k, r, dy, w and dS_T as views that
  walk time from its end (negative time strides), writes dv in forward
  order and returns G_0 = dS_0 as its final state.

No atomics: two calls give the same bits.  No call falls back from one
route to the other: a launch that fails raises.

What bounds it on an H100 at the training shape (4, 2048, 32, 64) bf16
(rwkv6-1.6b): its 375 MB of reads and writes take 0.11 ms at 3.35 TB/s;
its least arithmetic, 5 FMAs per state entry and step (10.7 GFLOP),
0.16 ms at 67 TFLOP/s of f32.  ``chip_smoke.py::wkv_bwd_bound`` prints it;
measured times stand in PERF.md.

Built at first use with nvcc (``kernels/_build.py``) into
``build/repro_torch/``, keyed by a hash of the source, and loaded with
ctypes: the serving library holds the general kernel and ``PLAN``'s
Hopper tile; the sweep library (``sweep=True``, ``-DWKV6_BWD_SWEEP``)
every tile of ``SWEEP_TILES``, for ``chip_smoke.py``'s timing.  Nothing
here runs at import time.
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
SWEEP_NAME = "wkv6_bwd_sweep"
SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6_bwd.cu"
MAX_HEAD_DIM = 64
# the kernels a call launches, in order
KERNELS = ("bwd", "dv")
ROUTES = ("hopper", "general")
SUB_STEPS = 16          # the general kernel's steps between checkpoints
HOPPER_HEAD_DIM = 64
# (R, C, SUB) of the Hopper kernel: R rows x C columns a thread, SUB steps
# a checkpoint; the fastest of SWEEP_TILES at (4, 2048, 32, 64) bf16 on an
# H100 (PERF.md)
PLAN = (1, 16, 8)
# tiles instantiated (csrc/wkv6_bwd.cu, WKV6_BWD_TILES): PLAN's alone in
# the serving library, these in the sweep library; chip_smoke.py times
# them all
TILES = (PLAN,)
SWEEP_TILES = ((2, 8, 8), (4, 4, 8), (1, 16, 8), (1, 8, 8), (2, 4, 8),
               (4, 8, 4))
# the source's layout constants (namespace hopper)
PRODUCER = 32           # threads of the producer warp
STAGES = 3
SMEM_MAX = 232448       # shared memory a block may use
ALIGN = 128
REGISTERS = 65536       # of an SM


def threads(tile) -> int:
    """Threads of a Hopper block: one per R x C tile of the 64 x 64 state,
    and the producer warp."""
    rows, cols, _ = tile
    return HOPPER_HEAD_DIM * HOPPER_HEAD_DIM // (rows * cols) + PRODUCER


def shared_memory(tile, dtype):
    """(bytes, sets of partials) of a Hopper block, as the source's
    ``Cfg`` lays them out: STAGES stages of f32 (SUB, 64) arrays of r, k,
    v, dy, w, v . dy, the 64 x 64 checkpoint and, for bf16, the TMA boxes
    of r, k, v, dy; two sets of partial sums (dr, dk, dw by step, column
    group and row) where they fit, else one; du's partials; barriers."""
    rows, cols, sub = tile
    hd = HOPPER_HEAD_DIM
    size = torch.finfo(dtype).bits // 8
    row_f = sub * hd * 4
    stage = (5 * row_f + -(-sub * 4 // ALIGN) * ALIGN + hd * hd * 4
             + (4 * sub * hd * size if size == 2 else 0))
    part = 3 * sub * (hd // cols) * hd * 4
    du = (threads(tile) - PRODUCER) * 4
    bars = 3 * STAGES * 8
    sets = 2 if STAGES * stage + 2 * part + du + bars + ALIGN <= SMEM_MAX \
        else 1
    return STAGES * stage + sets * part + du + bars + ALIGN, sets


def register_budget(tile) -> int:
    """Registers a thread may hold with one block an SM (the source's
    ``__launch_bounds__(THREADS, 1)``): the SM's 65536 over the block's
    threads in whole warps, in units of 8, at most 255."""
    warps = -(-threads(tile) // 32)
    return min(255, REGISTERS // (warps * 32) // 8 * 8)


def registers_needed(tile) -> int:
    """A lower estimate of a consumer's live registers at the end of a
    sub-chunk's recompute: the stash (SUB states of R x C), G (R x C), a
    step's operands (k, w of R rows, v, dy of C columns), the R row sums
    and 16 for addresses and counters.  ptxas's count is printed by
    chip_smoke.py (``ptxas_summary``)."""
    rows, cols, sub = tile
    return sub * rows * cols + rows * cols + 2 * rows + 2 * cols + rows + 16


def ck_swizzle(row: int) -> int:
    """The source's ``ck_swizzle``: chunk q (4 columns) of a checkpoint's
    row is stored at chunk q ^ ck_swizzle(row)."""
    return (row & 7) ^ ((row >> 3) & 3)


def checkpoint_shape(shape, steps: int = SUB_STEPS):
    """The states stored every ``steps`` steps, (b, H, ceil(s / steps),
    HDP, HDP) f32, for r of ``shape`` (b, s, H, hd): the general kernel's
    scratch (``steps`` = ``SUB_STEPS``), or the forward's checkpoints
    that the Hopper route reads (``steps`` = ``PLAN[2]``)."""
    b, s, h, hd = shape
    hdp = padded_head_dim(hd)
    return (b, h, -(-s // steps), hdp, hdp)


def checkpoint_states(ck):
    """The forward's checkpoints ``ck`` (b, H, n, 64, 64) with each row's
    chunks put back in place: the plain states, row-major."""
    hd = HOPPER_HEAD_DIM
    rows = torch.arange(hd).view(hd, 1)
    cols = torch.arange(hd).view(1, hd)
    swz = (rows & 7) ^ ((rows >> 3) & 3)
    index = 4 * ((cols // 4) ^ swz) + cols % 4
    return ck.gather(-1, index.to(ck.device).expand(ck.shape))


def _tma_ok(t) -> bool:
    """TMA's preconditions for one (b, s, h, hd) operand: head-dim stride
    1, base address and (batch, seq, head) strides positive multiples of
    16 bytes below 2^40."""
    size = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(0 < t.stride(i) * size < 2 ** 40
                    and (t.stride(i) * size) % 16 == 0 for i in range(3)))


def plan(r, k, v, w) -> str:
    """The route of a call's backward, from the forward's inputs, before
    the forward runs (only the "hopper" route needs its checkpoints):
    "hopper" for r, k, v of one dtype of ``DTYPES`` and w in f32 at hd 64,
    each of them a view TMA can read; "general" for everything else.
    Works on tensors of any device, the meta device included."""
    hopper = (r.dtype in DTYPES and k.dtype == r.dtype
              and v.dtype == r.dtype and w.dtype == torch.float32
              and r.dim() == 4 and r.shape[3] == HOPPER_HEAD_DIM
              and r.shape[0] <= 65535
              and all(_tma_ok(t) for t in (r, k, v, w)))
    return "hopper" if hopper else "general"


def build(sweep: bool = False) -> Path:
    """Compiles the source (with every tile of ``SWEEP_TILES`` if
    ``sweep``) unless a library of the same source hash is already
    built."""
    return _build.build(SOURCE, SWEEP_NAME if sweep else NAME,
                        ("-DWKV6_BWD_SWEEP",) if sweep else ())


@functools.lru_cache(maxsize=None)
def library(sweep: bool = False):
    """The built library with both entry points typed: general
    (``wkv6_bwd``) and Hopper (``wkv6_bwd_hopper``)."""
    lib = ctypes.CDLL(str(build(sweep)))
    lib.wkv6_bwd.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.wkv6_bwd_hopper.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    for fn in (lib.wkv6_bwd, lib.wkv6_bwd_hopper):
        fn.restype = ctypes.c_int
    return lib


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


def forward_checkpoints(r, k, v, w, u, state, steps):
    """K2's forward in training mode: the checkpoints every ``steps``
    steps that the Hopper route reads (y and the final state dropped)."""
    ck = torch.empty(checkpoint_shape(r.shape, steps), dtype=torch.float32,
                     device=r.device)
    kernel.wkv6_cuda(r, k, v, w, u, state, kernel.plan(r.shape, r.dtype),
                     checkpoints=ck, ck_steps=steps)
    return ck


def wkv6_bwd_cuda(r, k, v, w, u, state, dy, dstate=None, kernels=KERNELS,
                  route=None, checkpoints=None, tile=None, sweep=False):
    """Launches ``kernels`` (names of ``KERNELS``, all by default) on the
    current stream, "bwd" on ``route`` (``plan``'s by default).  r/k/v/dy
    (b, s, H, hd) in one dtype of ``DTYPES`` and w (b, s, H, hd) f32,
    each with head-dim stride 1; u (H, hd), state and ``dstate`` (b, H,
    hd, hd; None is zeros) contiguous f32.  On the "hopper" route:
    ``checkpoints``, the forward's (``checkpoint_shape(r.shape,
    tile[2])``), or None to run the forward in training mode for them;
    ``tile`` (R, C, SUB), ``PLAN`` by default, one of ``SWEEP_TILES``
    with ``sweep`` (the sweep library); a dy TMA cannot read is copied to
    contiguous.  Returns (dr, dk, dv in r's dtype, dw f32 (b, s, H, hd),
    du (H, hd) f32, dstate_0 (b, H, hd, hd) f32), each contiguous; what a
    skipped kernel would have written is left unwritten.  Raises on a
    failed launch."""
    _check(r, k, v, w, u, state, dy, dstate)
    if not set(kernels) <= set(KERNELS):
        raise ValueError(f"wkv6_bwd has kernels {KERNELS}, not {kernels}")
    route = plan(r, k, v, w) if route is None else route
    tile = PLAN if tile is None else tuple(tile)
    if route not in ROUTES:
        raise ValueError(f"wkv6_bwd has routes {ROUTES}, not {route!r}")
    if route == "hopper":
        if plan(r, k, v, w) != "hopper":
            raise ValueError("the hopper route takes hd 64 and r/k/v/w "
                             "that TMA can read")
        if tile not in (SWEEP_TILES if sweep else TILES):
            raise ValueError(f"no Hopper tile {tile}" + (
                "" if sweep else " in the serving library"))
        if not _tma_ok(dy):
            dy = dy.contiguous()
        want = checkpoint_shape(r.shape, tile[2])
        if checkpoints is None and "bwd" in kernels:
            checkpoints = forward_checkpoints(r, k, v, w, u, state, tile[2])
        elif checkpoints is not None and (
                tuple(checkpoints.shape) != want
                or checkpoints.dtype != torch.float32
                or not checkpoints.is_contiguous()
                or checkpoints.device != r.device):
            raise ValueError(f"the hopper route takes f32 checkpoints {want}"
                             f"; got {tuple(checkpoints.shape)} "
                             f"{checkpoints.dtype}")
    b, s, h, hd = r.shape
    dr, dk, dv = (torch.empty(r.shape, dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    du = torch.empty((b, h, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(state)
    g0 = torch.zeros_like(state) if dstate is None else dstate
    strides = (ctypes.c_longlong * 15)(
        *(t.stride(i) for t in (r, k, v, w, dy) for i in range(3)))
    # the forward kernel backward in time: r <- k, k <- r, v <- dy, y = dv
    rev = [_reversed(t) for t in (k, r, dy, w, dv)]
    rev_strides = (ctypes.c_longlong * 15)(*(x for _, st in rev for x in st))
    fwd_plan = kernel.plan(r.shape, r.dtype)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        if "bwd" in kernels:
            lib = library(sweep)
            ins = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   dy.data_ptr(), u.data_ptr())
            ds_ptr = None if dstate is None else dstate.data_ptr()
            outs = (dr.data_ptr(), dk.data_ptr(), dw.data_ptr(),
                    du.data_ptr())
            if route == "hopper":
                err = lib.wkv6_bwd_hopper(
                    *ins, ds_ptr, checkpoints.data_ptr(), *outs,
                    DTYPES[r.dtype], b, s, h, hd, strides, *tile, stream)
            else:
                ck = torch.empty(checkpoint_shape(r.shape),
                                 dtype=torch.float32, device=r.device)
                err = lib.wkv6_bwd(
                    *ins, state.data_ptr(), ds_ptr, *outs, ck.data_ptr(),
                    DTYPES[r.dtype], b, s, h, hd, strides, stream)
            if err != 0:
                raise RuntimeError(f"wkv6_bwd ({route}) launch failed: "
                                   f"error {err}")
        if "dv" in kernels:
            err = kernel.library()(
                *(ptr for ptr, _ in rev[:4]), u.data_ptr(), g0.data_ptr(),
                rev[4][0], ds0.data_ptr(), DTYPES[r.dtype], b, s, h, hd,
                rev_strides, *fwd_plan,
                kernel.chunk_steps(hd, r.dtype, fwd_plan), 1, None, 0,
                stream)
            if err != 0:
                raise RuntimeError(f"wkv6_bwd's dv pass (wkv6_fwd) launch "
                                   f"failed: CUDA error {err}")
    return dr, dk, dv, dw, du.sum(0), ds0
