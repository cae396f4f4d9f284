"""Flash attention as a hand-written CUDA kernel for Hopper (sm_90a).

Replaces ``flash_attention_pallas`` (body ``_kernel``) in
``src/repro/kernels/flash_attention/kernel.py``: the same blockwise
online-softmax attention, on (b, s, h, hd) tensors with GQA heads already
repeated.  v may be narrower than q and k (dv < hd columns, MLA's 128
beside q·k's 192): the function is then the TPU kernel applied to v
zero-padded to hd, and o is its first dv columns.  The source is
``csrc/flash_attention.cu``.

What bounds it on an H100 at the main-path shapes.  Prefill of
mistral-nemo-12b calls it with q/k/v (4, <=1024, 32, 128) in bf16, causal;
the Jamba cut's with 64 heads.  Each call reads q, k, v and writes o
once: 4 x 32 MiB, about 40 us at 3.35 TB/s.  Its products are 4 x hd
FLOPs per unmasked (query, key) pair, 34 GFLOP at s = 1024, about 35 us
at the 989 TFLOP/s bf16 tensor-core peak.  So the function is bound by
bytes and by the tensor cores about equally, and only wgmma products fed
by loads that overlap them can come near that bound.

Two variants, chosen before launch by ``plan`` from the dtype, the head
dim and the strides (a dispatch by shape; neither is a fallback for the
other, and a failed build, tensor-map encode or launch raises):

* ``"hopper"``: bf16 with (hd, dv) in ``HOPPER_HEAD_DIM_PAIRS`` and
  strides TMA takes (every call of the main paths).  Persistent blocks of
  one producer warpgroup, which streams Q, K and V by TMA into double-buffered
  shared memory guarded by mbarriers, and two consumer warpgroups of 64
  query rows each, which take turns at S = Q K^T and O += P V as wgmma (P
  from registers) and run the softmax in the log2 domain, with masks only
  on the tiles that cross the diagonal, the window's edge or the end of
  kv; units of 128 q by 128 kv rows come from an atomic counter, longest
  first within groups of heads whose K and V stay in L2.  hd 120
  (h2o-danube-3-4b) runs the layout and products of hd 128: TMA fills each
  row's columns 120..127 with zeros, which add nothing to S, and the
  epilogue stores only the first 120 columns of O.  MLA's (192, 128)
  multiplies q·k over three 64-column boxes a row and P V at hd 128's
  width, with one Q buffer so that its tiles fit in shared memory (serving
  only).  hd 256 (gemma3-4b) takes 64-row kv tiles and one Q buffer: a
  128 x 256 Q tile is 64 KB, so 128-row K and V tiles in two stages
  would need 320 KB of the 227 a block has, and a consumer thread's O
  at 256 columns is 128 f32 registers, beside which only a 64-key S and P
  fit; S = Q K^T runs over four 64-column boxes, P V as m64n256k16.
* ``"general"``: everything else (f32, other head dims up to 256, any dv
  <= hd, bf16 strides TMA refuses).  bf16 goes through mma.sync
  tensor-core products from 4 warps, f32 through FMAs on the CUDA cores
  (67 TFLOP/s; TF32 would miss f32's tolerance); 64-row tiles loaded
  between barriers, without overlap.  It is what every call took before
  the Hopper variant was added.

Training mode (``lse``, Hopper variant at hd = dv in ``LSE_HEAD_DIMS``,
64, 128 and 256, the head dims the main paths train at): the same
kernel, a separate instantiation, also writes each row's log-sum-exp
(natural log units, the scale and softcap folded in) for the backward
(``kernel_bwd.py``), which then needs no third S = Q K^T: its Hopper
variant at hd 64 and 128, its general one at hd 256.  Serving passes no
buffer and runs the instantiation it ran before.

Both skip tiles above the causal diagonal or before the window (half the
work at s = 1024) and schedule the longest q tiles first.  Measured times
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

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_ROOT = _build.BUILD_ROOT
NVCC_FLAGS = _build.NVCC_FLAGS
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("hopper", "general")
# (q·k head dim, v/o head dim) pairs of the Hopper variant; (192, 128) is
# deepseek-v3-671b's MLA prefill (128 nope + 64 rope, v 128)
HOPPER_HEAD_DIM_PAIRS = ((64, 64), (120, 120), (128, 128), (192, 128),
                         (256, 256))
HOPPER_HEAD_DIMS = tuple(dict.fromkeys(hd for hd, _ in HOPPER_HEAD_DIM_PAIRS))
# head dims (hd = dv) at which the Hopper variant has a training mode
# (writes the LSE): those of the Hopper backward (64, 128) and gemma3's
# 256, whose general backward reads it; not hd 120 or MLA's (192, 128),
# which no main path trains at
LSE_HEAD_DIMS = (64, 128, 256)
HOPPER_BQ = 128   # query rows of a Hopper unit of work
# rows of a (batch, head) in an LSE buffer: sq rounded up to this, so that
# the backward's 64- and 128-row slices of it are whole and 16-byte aligned
LSE_ROW_ALIGN = 128


def library_path() -> Path:
    return _build.library_path(SOURCE, NAME)


def build() -> Path:
    """Compiles the source unless a library of the same source hash is
    already built."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def library():
    """The built library with both entry points typed: general
    (``flash_attention_fwd``) and Hopper (``flash_attention_fwd_hopper``)."""
    return typed(ctypes.CDLL(str(build())))


def typed(lib):
    """``lib`` (this source's library, or a library built from an edited
    copy of it) with both entry points' argument and result types set."""
    common = ([ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong),
                                    ctypes.c_float, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_float,
                                    ctypes.c_void_p])
    lib.flash_attention_fwd.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] + common)
    lib.flash_attention_fwd_hopper.argtypes = (
        [ctypes.c_void_p] * 4 + common[:-1]
        + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2)
    for fn in (lib.flash_attention_fwd, lib.flash_attention_fwd_hopper):
        fn.restype = ctypes.c_int
    return lib


def _tma_ok(t) -> bool:
    """TMA's preconditions for one (b, s, h, hd) bf16 operand: head-dim
    stride 1, base address and (batch, seq, head) strides multiples of 16
    bytes, strides below 2^40 bytes."""
    size = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all((t.stride(i) * size) % 16 == 0
                    and t.stride(i) * size < 2 ** 40 for i in range(3)))


def plan(q, k, v) -> str:
    """Which variant a call takes, from what the tensors are (dtype, head
    dims, strides, alignment), before any launch: "hopper" for bf16 with
    (hd, dv) in ``HOPPER_HEAD_DIM_PAIRS`` (64, 64), (120, 120), (128, 128),
    (192, 128), (256, 256) whose q/k/v TMA can read (an expanded GQA
    view's stride-0 heads included) and
    whose units of work (q tiles x batch x heads) an int counts; "general"
    for everything else.  hd 120's head stride of 240 bytes is a multiple
    of 16, so h2o-danube-3-4b's contiguous q/k/v (and a (b, s, h, 128)
    storage seen as hd 120) take "hopper".  Works on tensors of any
    device, the meta device included."""
    b, sq, h, hd = q.shape
    hopper = (all(t.dtype == torch.bfloat16 for t in (q, k, v))
              and (hd, v.shape[3]) in HOPPER_HEAD_DIM_PAIRS
              and -(-sq // HOPPER_BQ) * b * h < 2 ** 31
              and all(_tma_ok(t) for t in (q, k, v)))
    return "hopper" if hopper else "general"


def writes_lse(q, k, v) -> bool:
    """Whether a call's forward writes an LSE in training mode: it takes
    the Hopper variant at hd = dv in ``LSE_HEAD_DIMS``."""
    return (plan(q, k, v) == "hopper" and q.shape[3] in LSE_HEAD_DIMS
            and v.shape[3] == q.shape[3])


def lse_buffer(q):
    """An LSE buffer for the forward's training mode: f32 (b, h, sq
    rounded up to ``LSE_ROW_ALIGN``) on q's device; its rows past sq are
    never written."""
    b, sq, h, _ = q.shape
    rows = -(-sq // LSE_ROW_ALIGN) * LSE_ROW_ALIGN
    return torch.empty((b, h, rows), dtype=torch.float32, device=q.device)


def lse_fits(lse, q) -> bool:
    """Whether ``lse`` is a buffer ``lse_buffer(q)`` could have made."""
    b, sq, h, _ = q.shape
    return (lse.dtype == torch.float32 and lse.device == q.device
            and lse.dim() == 3 and lse.shape[:2] == (b, h)
            and lse.shape[2] >= sq and lse.shape[2] % LSE_ROW_ALIGN == 0
            and lse.is_contiguous())


def flash_attention_cuda(q, k, v, variant, *, causal=True, window=0,
                         softcap=0.0, lse=None):
    """Launches ``variant`` of the kernel on the current stream and returns
    o (b, sq, h, dv) in q.dtype, dv = v.shape[3] <= hd.  The caller has
    checked device, dtype and shapes and chosen the variant (``plan``); the
    Hopper variant raises on what it does not take rather than run
    another.  ``lse``: a ``lse_buffer(q)`` into which the Hopper variant
    also writes each row's log-sum-exp (training mode, at hd = dv in
    ``LSE_HEAD_DIMS``); the general variant takes none."""
    if variant not in VARIANTS:
        raise ValueError(f"no flash attention variant {variant!r}")
    b, sq, h, hd = q.shape
    if lse is not None and (variant != "hopper" or not lse_fits(lse, q)):
        raise ValueError(f"lse must be a contiguous f32 (b, h, rows) buffer "
                         f"from lse_buffer(q) for the hopper variant; got "
                         f"{variant!r}, {tuple(lse.shape)} {lse.dtype}")
    if lse is not None and (hd not in LSE_HEAD_DIMS or v.shape[3] != hd):
        raise ValueError(f"the hopper forward writes an lse only at hd = "
                         f"dv in {LSE_HEAD_DIMS}, not ({hd}, {v.shape[3]})")
    skv, dv = k.shape[1], v.shape[3]
    o = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    args = (b, sq, skv, h, hd, dv, strides, 1.0 / (hd ** 0.5), int(causal),
            int(window), float(softcap))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "hopper":
            # the persistent blocks' work counter
            counter = torch.zeros(1, dtype=torch.int32, device=q.device)
            err = library().flash_attention_fwd_hopper(
                *ptrs, *args, 0 if lse is None else lse.data_ptr(),
                0 if lse is None else lse.shape[2], counter.data_ptr(),
                stream)
        else:
            err = library().flash_attention_fwd(*ptrs, DTYPES[q.dtype],
                                                *args, stream)
    if err == 2000:
        raise RuntimeError("flash_attention_fwd_hopper: libcuda has no "
                           "cuTensorMapEncodeTiled")
    if 1000 <= err < 2000:
        raise RuntimeError(f"flash_attention_fwd_hopper: a tensor map "
                           f"failed to encode (CUresult {err - 1000})")
    if err != 0:
        raise RuntimeError(f"flash_attention {variant} launch failed: CUDA "
                           f"error {err}")
    return o
