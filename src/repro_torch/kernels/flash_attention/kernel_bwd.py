"""Flash attention's backward as hand-written CUDA kernels for Hopper
(sm_90a): dq, dk, dv of the forward in ``kernel.py``.

The TPU side has no backward kernel: the reference trains through the jnp
twin of ``flash_attention_pallas`` (``src/repro/models/attention.py::
flash_attention``), differentiated by JAX.  The port's attention goes
through K1, so its gradient is this kernel.  The source is
``csrc/flash_attention_bwd.cu``, a library of its own: the forward's
source and library stay apart.

Two variants, three kernels a call each, no atomics (two calls give the
same bits); ``plan`` picks one before the forward (a dispatch by dtype,
head dim and strides; neither is a fallback for the other, and a failed
tensor-map encode or launch raises):

* ``"hopper"``: bf16 with hd 64 or 128 (``HOPPER_HEAD_DIMS``) whose
  q/k/v/o TMA can read (every training call of the dense decoders).  Its
  forward ran K1's Hopper variant in training mode, which wrote each
  row's log-sum-exp.
  FlashAttention-3's schedule: (a) preprocess, D = rowsum(dO * o); (b)
  dK/dV, one persistent unit per 128-row kv tile, a producer warp
  streaming Q, dO, LSE and D by TMA into a 3-stage mbarrier ring, two
  consumer warpgroups computing S^T, dP^T, dV and dK as wgmma (P^T and
  dS^T from registers); (c) dQ, one unit per 128-row q tile, streaming K
  and V, S, dP and dQ as wgmma.  Streamed tiles of 128 rows
  (``HOPPER_RING_ROWS``), 64 for dK/dV at hd 128.  7 products of 2 hd
  FLOPs per unmasked pair.
* ``"general"``: everything else (f32, any hd up to 256 but 64 and 128
  in bf16, v narrower than q and k, strides TMA refuses): hd 120 and
  MLA's (192, 128) too, though their forwards take the forward's Hopper
  variant (no LSE), and hd 256 (gemma3-4b), whose Hopper forward writes
  the LSE in training mode.  The first design: (a) stats, each row's LSE
  (a third S = Q K^T) and D, or D alone where the caller hands it the
  forward's LSE (bf16, ``lse``); (b) dK/dV per 64-row kv tile; (c) dQ
  per 64-row q tile, both reading the LSE; bf16 through mma.sync, f32
  through FMAs on the CUDA cores, tiles loaded between barriers.  Above
  hd 128 bf16 runs two warps a 16-row slice, each owning half the
  gradient's columns (S and dP computed by both), and f32 takes 32-row
  tiles.  7 products a pair in (b) and (c) and 1 in stats (none with the
  forward's LSE); 11 in (b) and (c) above hd 128 in bf16.
  D, dP and dV run over v's dv columns.

What bounds it on an H100 at the training shape, (4, 2048, 36, 64) bf16
causal (minicpm-2b): 302.1 M unmasked pairs a call.  The function needs
5 products a pair (S, dP, dV, dK, dQ), 193.4 GFLOP, 0.196 ms at 989
TFLOP/s, above its 302 MB of reads and writes (0.090 ms); the Hopper
design's own floor, 7 products, is 270.7 GFLOP, 0.274 ms.  Measured
times stand in PERF.md.

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
from repro_torch.kernels.flash_attention import kernel

NAME = "flash_attention_bwd"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
MAX_HEAD_DIM = 256
# the general variant's head dims padded in shared memory (q·k's HDP,
# v's DVP), as the source's launch_for_head_dim instantiates them
GENERAL_HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128),
                     (192, 192), (256, 256))
VARIANTS = ("hopper", "general")
# the kernels a call of each variant launches, in order
KERNELS = {"hopper": ("preprocess", "dkdv", "dq"),
           "general": ("stats", "dkdv", "dq")}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# rows of a Hopper unit (the kernel's UNIT_ROWS), and of a streamed (ring)
# tile by kernel and head dim (its DkdvCfg / DqCfg::RING): 128 where the
# accumulators fit a consumer's registers, 64 for dK/dV at hd 128
HOPPER_UNIT_ROWS = 128
# the Hopper backward's head dims; the forward's training mode
# (``kernel.LSE_HEAD_DIMS``) also takes 256, whose backward is general
HOPPER_HEAD_DIMS = (64, 128)
HOPPER_RING_ROWS = {"dkdv": {64: 128, 128: 64}, "dq": {64: 128, 128: 128}}


def build() -> Path:
    """Compiles the source unless a library of the same source hash is
    already built."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def library():
    """The built library with both entry points typed: general
    (``flash_attention_bwd``) and Hopper (``flash_attention_bwd_hopper``)."""
    lib = ctypes.CDLL(str(build()))
    tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 8
        + tail)
    lib.flash_attention_bwd_hopper.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 5
        + tail)
    for fn in (lib.flash_attention_bwd, lib.flash_attention_bwd_hopper):
        fn.restype = ctypes.c_int
    return lib


def plan(q, k, v, o=None) -> str:
    """Which variant the backward of a call takes, decided before its
    forward (only the forward's Hopper variant writes the LSE the Hopper
    backward reads): "hopper" where the forward takes its Hopper variant
    (``kernel.plan``: bf16, q/k/v TMA can read, an expanded GQA view's
    stride-0 heads and a (b, h, s, hd) storage included) at a head dim of
    ``HOPPER_HEAD_DIMS`` (64, 128) and o, if given, is bf16 TMA can read
    (the forward's own o always is); "general" for everything else, hd
    120 and MLA's (192, 128) included, whose forwards still take the
    Hopper variant (serving instantiations, no LSE), and every hd above
    128: at hd 256 the forward's Hopper variant writes the LSE
    (``kernel.writes_lse``), which the general route then reads.  dO
    never changes the route: one TMA refuses is copied to contiguous by
    the caller (``dout_ok``, ``ops._FlashAttention``).
    Works on tensors of any device, the meta device included."""
    hopper = (kernel.plan(q, k, v) == "hopper"
              and q.shape[3] in HOPPER_HEAD_DIMS
              and v.shape[3] == q.shape[3]
              and (o is None or (o.dtype == torch.bfloat16
                                 and kernel._tma_ok(o))))
    return "hopper" if hopper else "general"


def dout_ok(do) -> bool:
    """Whether the Hopper backward reads dO as it is (else the caller
    copies it to contiguous)."""
    return do.dtype == torch.bfloat16 and kernel._tma_ok(do)


def _check(q, k, v, o, do):
    b, sq, h, hd = q.shape
    skv, dv = k.shape[1], v.shape[3]
    tensors = (q, k, v, o, do)
    if (any(t.device != q.device or t.dtype != q.dtype
            or t.stride(3) != 1 for t in tensors)
            or q.device.type != "cuda" or q.dtype not in DTYPES
            or hd > MAX_HEAD_DIM or not 1 <= dv <= hd
            or k.shape != (b, skv, h, hd) or v.shape != (b, skv, h, dv)
            or o.shape != (b, sq, h, dv) or do.shape != o.shape):
        raise ValueError(
            f"flash_attention_bwd takes q (b, sq, h, hd <= {MAX_HEAD_DIM}), "
            f"k (b, skv, h, hd), v (b, skv, h, dv <= hd), o/do (b, sq, h, "
            f"dv), one CUDA device and "
            f"dtype of {list(DTYPES)}, head-dim stride 1; got "
            f"{[(tuple(t.shape), t.dtype, t.device.type) for t in tensors]}")


def launch(q, k, v, o, do, variant, *, lse=None, causal=True, window=0,
           softcap=0.0, kernels=None):
    """Launches ``kernels`` (names of ``KERNELS[variant]``, all by
    default) of ``variant`` on the current stream.  Returns (dq, dk, dv,
    lse, delta): the gradients, contiguous, in the dtypes of q, k, v, and
    the (b, h, rows) f32 statistics (the general variant's stats kernel
    writes both unless it is handed the forward's ``lse``, bf16 only; the
    Hopper one always reads the forward's ``lse`` and writes delta).  A
    tensor a skipped kernel would have written is left unwritten."""
    run, outs = launcher(q, k, v, o, do, variant, lse=lse, causal=causal,
                         window=window, softcap=softcap, kernels=kernels)
    run()
    return outs


def launcher(q, k, v, o, do, variant, *, lse=None, causal=True, window=0,
             softcap=0.0, kernels=None):
    """``launch``'s checks and allocations, done once: returns (run,
    outputs), where each ``run()`` launches the kernels again into the same
    outputs on the stream current now, and raises on a failed launch.
    For timing a kernel without the host's time between launches."""
    if variant not in VARIANTS:
        raise ValueError(f"no flash attention backward variant {variant!r}")
    _check(q, k, v, o, do)
    names = KERNELS[variant] if kernels is None else tuple(kernels)
    if not set(names) <= set(KERNELS[variant]):
        raise ValueError(f"{variant} has kernels {KERNELS[variant]}, not "
                         f"{names}")
    which = sum(1 << KERNELS[variant].index(n) for n in set(names))
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    lse_in = lse is not None
    if variant == "hopper":
        if (q.dtype != torch.bfloat16 or hd not in HOPPER_HEAD_DIMS
                or v.shape[3] != hd or lse is None
                or not kernel.lse_fits(lse, q)):
            raise ValueError(
                f"the hopper backward takes bf16 hd = dv in "
                f"{HOPPER_HEAD_DIMS} and the forward's lse "
                f"(kernel.lse_buffer); got {q.dtype}, hd {hd}, dv "
                f"{v.shape[3]}, lse "
                f"{None if lse is None else tuple(lse.shape)}")
    elif lse_in and (q.dtype != torch.bfloat16
                     or not kernel.lse_fits(lse, q)):
        raise ValueError(f"the general backward reads a forward's lse in "
                         f"bf16 only, from kernel.lse_buffer; got {q.dtype}, "
                         f"lse {tuple(lse.shape)} {lse.dtype}")
    elif not lse_in:
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    tensors = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(
        *(t.stride(i) for t in tensors for i in range(3)))
    ptrs = [t.data_ptr() for t in tensors] + [lse.data_ptr(),
                                              delta.data_ptr()]
    tail = (strides, 1.0 / (hd ** 0.5), int(causal), int(window),
            float(softcap), which)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    if variant == "hopper":
        fn = library().flash_attention_bwd_hopper
        args = (*ptrs, lse.shape[2], b, sq, skv, h, hd, *tail, stream)
    else:
        fn = library().flash_attention_bwd
        args = (*ptrs, lse.shape[2], int(lse_in), DTYPES[q.dtype], b, sq,
                skv, h, hd, v.shape[3], *tail, stream)

    def run():
        err = fn(*args)
        if err == 2000:
            raise RuntimeError("flash_attention_bwd_hopper: libcuda has no "
                               "cuTensorMapEncodeTiled")
        if 1000 <= err < 2000:
            raise RuntimeError(f"flash_attention_bwd_hopper: a tensor map "
                               f"failed to encode (CUresult {err - 1000})")
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd {variant} launch "
                               f"failed: CUDA error {err}")

    return run, (dq, dk, dv, lse, delta)


def flash_attention_bwd_cuda(q, k, v, o, do, variant, *, lse=None,
                             causal=True, window=0, softcap=0.0):
    """Launches ``variant``'s three kernels on the current stream and
    returns (dq, dk, dv), contiguous, in the dtypes of q, k, v.  q is (b,
    sq, h, hd), k (b, skv, h, hd), v (b, skv, h, dv) and o/do (b, sq, h,
    dv) with dv <= hd, on one card, in one dtype of ``DTYPES``, hd at most
    ``MAX_HEAD_DIM``, head-dim stride 1; "hopper" also needs bf16, dv = hd
    of 64 or 128, strides TMA reads and the forward's ``lse``; "general"
    reads the forward's ``lse`` where it is given one (bf16), else
    recomputes it.  Else it raises."""
    return launch(q, k, v, o, do, variant, lse=lse, causal=causal,
                  window=window, softcap=softcap)[:3]
