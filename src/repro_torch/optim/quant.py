"""Block-wise int8 quantization of optimizer state, the port of
``repro.optim.quant``: an int8 payload and f32 block scales, blocks of
``BLOCK`` values along the last axis (shape-preserving), or over the
flattened tensor (the reference's original flat layout).

``torch.round`` rounds half to even, as ``jnp.round`` does, so the same
f32 values quantize to the same bits.  The reference's error-feedback
int8 gradient compression (``compress_with_feedback``,
``compressed_psum``) runs on a mesh's ``Collectives``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


class QTensor:
    """int8 ``q`` and f32 ``scale`` of a tensor of ``shape``.  Shape-
    preserving: q is (*lead, ceil(last / B), B) and scale (*lead,
    ceil(last / B), 1); flat: q (n_blocks, B), scale (n_blocks, 1).  In a
    checkpoint its children are keyed "0" (q) and "1" (scale), as the
    reference's registered pytree node flattens."""

    def __init__(self, q, scale, shape):
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)

    def tree_children(self):
        return (self.q, self.scale)

    def __repr__(self):
        return (f"QTensor(q={self.q!r}, scale={self.scale!r}, "
                f"shape={self.shape})")


def _blocks_to_q(blocks):
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_flat(x, block=BLOCK):
    """The original flat-blocked layout: blocks over the flattened
    tensor."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    q, scale = _blocks_to_q(flat.reshape(-1, block))
    return QTensor(q, scale, tuple(x.shape))


def dequantize_flat(t):
    flat = (t.q.float() * t.scale).reshape(-1)
    n = 1
    for s in t.shape:
        n *= s
    return flat[:n].reshape(t.shape)


def quantize(x, block=BLOCK):
    """Shape-preserving blocks along the last axis."""
    shape = tuple(x.shape)
    if not shape:
        x = x.reshape(1)
    pad = (-x.shape[-1]) % block
    xf = x.float()
    if pad:
        xf = F.pad(xf, (0, pad))
    q, scale = _blocks_to_q(xf.reshape(*xf.shape[:-1], -1, block))
    return QTensor(q, scale, shape)


def dequantize(t: QTensor):
    if t.q.dim() == 2 and len(t.shape) != 1:      # flat layout
        return dequantize_flat(t)
    full = t.q.float() * t.scale
    full = full.reshape(*full.shape[:-2], -1)
    last = t.shape[-1] if t.shape else 1
    if full.shape[-1] != last:
        full = full[..., :last]
    return full.reshape(t.shape)


def is_qtensor(x):
    return isinstance(x, QTensor)


# ---------------------------------------------------------------------------
# error-feedback int8 gradient compression (pure data-parallel meshes)


def compress_with_feedback(grad, error):
    """(int8 QTensor, new error): grad + error quantized; the residual is
    carried to the next step (EF-SGD / 1-bit-Adam style)."""
    target = grad.float() + error
    q = quantize(target)
    return q, target - dequantize(q)


def compressed_psum(grad, error, comm, axes):
    """int8 on the wire, as the reference models it: quantize locally,
    psum the int32-cast payload times its scales over ``axes`` (a
    ``Collectives``' axes), keep the quantization residual locally.
    Returns (the sum in grad's dtype, new error).  The sum is read back
    from the flattened blocks as the reference reads it."""
    q, new_error = compress_with_feedback(grad, error)
    summed = comm.psum(q.q.to(torch.int32) * q.scale, axes)
    n = 1
    for s in q.shape:
        n *= s
    out = summed.reshape(-1)[:n].reshape(q.shape)
    return out.to(grad.dtype), new_error
