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
TFLOP/s (H100 SXM data sheet).  The steps of a head form a dependent
chain, and there are only 128 (batch, head) chains at that shape, one
per SM.  The design spreads each chain's state over a block's consumer
threads in tiles of ``hd / G`` rows by ``C`` columns (``G`` threads per
column), each tile in registers, with y's partial sums reduced through
shared memory; ``CB`` blocks per head each own ``hd / CB`` columns.
Producer warps copy chunks of steps into shared memory with cp.async, a
chunk ahead of the consumers, and sum the rank-1 ``u`` term of each
step, so the loads overlap the recurrence.
The kernel issues 3 f32 instructions per state entry and step (k·v, the
state's FMA, y's FMA) against the bound's 2, so its own floor is 1.5x
the bound (about 48 us at that shape); every step's shared-memory reads
of r, k, w and one consumer warp per scheduler keep it above that.

``plan(shape, dtype)`` returns ``PLAN`` = (G, C, CB) before any
launch, in plain Python that the CPU tests reach, and raises for a head
dim past 64; ``ops.wkv6`` always launches it.  ``chip_smoke.py`` times
every candidate in ``CANDIDATES`` in one call; ``PLAN`` is the fastest
it measured.  Measured times stand in PERF.md.

The library is built at first use with nvcc (``kernels/_build.py``) into
``build/repro_torch/`` at the repository root, keyed by a hash of the
source, and loaded with ctypes.  It instantiates ``PLAN``'s tile alone;
the sweep library (``sweep=True``: every tile of ``SWEEP_TILES``) is
built only when a caller asks for it, as chip_smoke.py and the card
tests do.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "wkv6"
SWEEP_NAME = "wkv6_sweep"
SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
MAX_HEAD_DIM = 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (G, C, CB): G threads per state column, C columns per thread, CB blocks
# per (batch, head); the fastest candidate at (4, 1024, 32, 64) bf16 on
# an H100 (PERF.md).  Head dims 16 and 32 take it too, untimed.
PLAN = (8, 4, 1)
# (G, C) with a kernel instantiated (csrc/wkv6.cu, WKV6_PLANS): PLAN's
# alone in the serving library; in the sweep library every tile of at
# most 64 entries a thread
TILES = (PLAN[:2],)
SWEEP_TILES = ((1, 1), (2, 1), (4, 1), (8, 1), (16, 1), (2, 2), (4, 2),
               (4, 4), (8, 2), (8, 4), (8, 8), (16, 2), (16, 4), (16, 8))
COL_BLOCKS = (1, 2, 4)             # CB the kernel takes
PRODUCERS = 128                    # threads of a block's producer warps
SMEM_BUDGET = 224 * 1024           # shared memory of a head's CB blocks
MAX_CHUNK = 64                     # steps staged per buffer, at most


def padded_head_dim(hd: int) -> int:
    """The head dim the kernel runs at: 16, 32 or 64."""
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    return 16 if hd <= 16 else 32 if hd <= 32 else 64


def threads(hd: int, plan) -> int:
    """Threads of one block under ``plan`` = (G, C, CB): the consumers that
    hold the state (whole warps) and ``PRODUCERS`` that stage the steps."""
    groups, cols, col_blocks = plan
    consumers = padded_head_dim(hd) // col_blocks // cols * groups
    return -(-consumers // 32) * 32 + PRODUCERS


def chunk_steps(hd: int, dtype, plan) -> int:
    """Steps per chunk: as many as the layout of ``csrc/wkv6.cu``
    (``Layout``) fits in ``SMEM_BUDGET`` over CB, so that the CB blocks of
    a head share an SM; at most ``MAX_CHUNK``.  Per step: two buffers of
    the rows of w (f32) and r, k, v (in ``dtype``) and a, and G padded
    rows of partial sums of y."""
    groups, _, col_blocks = plan
    hdp = padded_head_dim(hd)
    size = torch.finfo(dtype).bits // 8
    step_bytes = 2 * (hdp * (4 + 3 * size) + 4) + groups * (hdp + 4) * 4
    return min(MAX_CHUNK, SMEM_BUDGET // col_blocks // step_bytes)


def fits(hd: int, plan, sweep: bool = False) -> bool:
    """Whether the library (the sweep library if ``sweep``) has an
    instantiation for ``plan`` at ``hd``: (G, C) in ``TILES`` (or
    ``SWEEP_TILES``), CB in ``COL_BLOCKS``, C dividing a block's columns,
    at most 1024 threads a block."""
    groups, cols, col_blocks = plan
    hdp = padded_head_dim(hd)
    tiles = SWEEP_TILES if sweep else TILES
    return ((groups, cols) in tiles and col_blocks in COL_BLOCKS
            and (hdp // col_blocks) % cols == 0
            and threads(hd, plan) <= 1024)


# (G, C, CB, pipelined) timed by chip_smoke.py at the main-path shape,
# through the sweep library: one column a thread (C = 1) at every G and
# CB with the double buffer (G = 16, CB = 1 is left out: 1024 consumers
# and the producers are more threads than a block may have), G = 4 (and
# G = 1, CB = 1, the candidate closest to a thread-per-column kernel)
# without it; then every C > 1 at every CB
CANDIDATES = [cand for cand in
              [(g, 1, cb, True) for g in (1, 2, 4, 8, 16)
               for cb in COL_BLOCKS]
              + [(4, 1, cb, False) for cb in COL_BLOCKS] + [(1, 1, 1, False)]
              + [(g, c, cb, True) for g, c in SWEEP_TILES if c > 1
                 for cb in COL_BLOCKS]
              if fits(MAX_HEAD_DIM, cand[:3], sweep=True)]


def plan(shape, dtype):
    """(G, C, CB) for r of ``shape`` (b, s, H, hd) and ``dtype``, before
    any launch: ``PLAN`` for every head dim and dtype.  Raises for hd >
    64."""
    padded_head_dim(shape[3])
    return PLAN


def _name(sweep: bool) -> str:
    return SWEEP_NAME if sweep else NAME


def library_path(sweep: bool = False) -> Path:
    return _build.library_path(SOURCE, _name(sweep))


def build(sweep: bool = False) -> Path:
    """Compiles the source (with every tile of ``SWEEP_TILES`` if
    ``sweep``) unless a library of the same source hash is already
    built."""
    return _build.build(SOURCE, _name(sweep),
                        ("-DWKV6_SWEEP",) if sweep else ())


@functools.lru_cache(maxsize=None)
def library(sweep: bool = False):
    lib = ctypes.CDLL(str(build(sweep)))
    fn = lib.wkv6_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def wkv6_cuda(r, k, v, w, u, state, plan, pipelined=True, sweep=False):
    """Launches the kernel under ``plan`` = (G, C, CB) on the current
    stream, from the sweep library if ``sweep``; ``pipelined`` False
    keeps one buffer, so that copies and steps do not overlap (for timing
    the double buffer).  r/k/v (b, s, H, hd) in one dtype, w (b, s, H,
    hd) f32, u (H, hd) and state (b, H, hd, hd) contiguous f32; the caller
    has checked them.  Returns (y (b, s, H, hd) in r.dtype, final state
    (b, H, hd, hd) f32)."""
    b, s, h, hd = r.shape
    if not fits(hd, plan, sweep):
        raise ValueError(f"no WKV6 plan (G, C, CB) = {tuple(plan)} for hd "
                         f"{hd}" + ("" if sweep else " in the serving "
                                    "library"))
    groups, cols, col_blocks = plan
    y = torch.empty((b, s, h, hd), dtype=r.dtype, device=r.device)
    s_out = torch.empty_like(state)
    strides = (ctypes.c_longlong * 15)(
        *(t.stride(i) for t in (r, k, v, w, y) for i in range(3)))
    with torch.cuda.device(r.device):
        err = library(sweep)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            DTYPES[r.dtype], b, s, h, hd, strides, groups, cols, col_blocks,
            chunk_steps(hd, r.dtype, plan), int(pipelined),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: CUDA error {err}")
    return y, s_out
