"""Block-wise int8 quantization of optimizer state, the port of
``repro.optim.quant``: an int8 payload and f32 block scales, blocks of
``BLOCK`` values along the last axis (shape-preserving), or over the
flattened tensor (the reference's original flat layout).

``torch.round`` rounds half to even, as ``jnp.round`` does, so the same
f32 values quantize to the same bits.  The reference's error-feedback
int8 gradient compression (``compress_with_feedback``,
``compressed_psum``) runs on a mesh's ``Collectives``.

On a mesh the reference quantizes the logical array under GSPMD: its
blocks run along the whole leaf's last dim (shape-preserving) or over
the whole flattened leaf (flat), and ``train_state_shardings`` gives
each device a block of them (``moment_spec``).  A rank holds its shard
of the param, which need not be made of whole blocks: mixtral-8x7b's
``lm_head`` (4096, 32000) cut over `model` = 2 holds 62.5 blocks a
rank.  ``MomentPlan`` says, for one leaf, how this rank's moments are
quantized so that it stores exactly the reference's blocks that
``moment_spec`` gives it: where the rank's entries are those blocks'
("aligned"), it quantizes them locally; otherwise it gathers the new f32
moment over the axes that cut the blocks' span (the last dim, or the
whole leaf for the flat layout), quantizes the whole span, keeps its
blocks, and on load gathers the blocks it lacks and takes its own
entries back out.  Which case a leaf takes depends on its spec and its
shape only, never on the rank: every rank of a group issues the same
collectives.  Plans are made once (``moment_plans``), not a step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.distribution import sharding as S

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
# quantized moments on a mesh (module docstring)


def _is_flat(shape, flat):
    """The flat layout for a leaf of ``shape``: a 1-D leaf's flat blocks
    are its shape-preserving ones, and the reference lays them out so."""
    return flat and len(shape) != 1


def n_blocks(shape, flat):
    """The reference's block count: along the last dim, or over the
    flattened leaf."""
    if _is_flat(shape, flat):
        return -(-math.prod(shape) // BLOCK)
    return -(-(shape[-1] if shape else 1) // BLOCK)


def moment_spec(shape, pspec, dist, flat):
    """The spec of a quantized moment's ``q`` (and ``scale``) for a param
    of ``shape`` and spec ``pspec``, as the reference's
    ``train_state_shardings`` gives it (``src/repro/training/step.py``):
    flat, the block dim over `data` where it divides the block count;
    shape-preserving, the param's spec with its last dim's axis moved to
    the block dim (a ``sharding.Parts`` entry as its plain axis: the
    blocks are cut contiguously), replicated where the block count does
    not divide that axis."""
    nb = n_blocks(shape, flat)
    if _is_flat(shape, flat):
        n = dist.axis_size("data") if dist.active else 1
        ax = "data" if dist.active and nb % n == 0 and nb >= n else None
        return (ax, None)
    if not shape:
        return (None, None)
    dims = tuple(pspec)
    last = dims[-1]
    if last is not None:
        last = str(last) if isinstance(last, str) else tuple(last)
        if nb % math.prod(dist.axis_size(a) for a in S.cut_axes(
                last, train=True)):
            last = None
    return (*dims[:-1], last, None)


class MomentPlan:
    """One leaf's quantized moment on this rank of a mesh (module
    docstring): ``zeros``, ``store`` (the rank's new f32 moment -> its
    ``QTensor``) and ``load`` (its ``QTensor`` -> the rank's f32
    moment).  ``received`` counts the bytes this rank's gathers brought
    in since it was last zeroed."""

    def __init__(self, shape, pspec, dist, flat):
        comm = dist.comm
        self.dist, self.shape, self.pspec = dist, tuple(shape), pspec
        self.flat = _is_flat(self.shape, flat)
        self.qspec = moment_spec(self.shape, pspec, dist, flat)
        self.local_shape = tuple(
            n // comm.axis_size(S.cut_axes(e, train=True))
            for n, e in zip(self.shape, pspec))
        nb = n_blocks(self.shape, flat)
        self.blk_axes = S.cut_axes(self.qspec[-2], train=True)
        n, j = comm.axis_size(self.blk_axes), comm.axis_index(self.blk_axes)
        self.b0, self.b1 = j * nb // n, (j + 1) * nb // n
        cut = [d for d, e in enumerate(pspec) if S.cut_axes(e, train=True)]
        if self.flat:
            # a contiguous run of the flattened leaf: cut on dim 0 alone,
            # by the block dim's axes, in whole blocks
            local = math.prod(self.local_shape)
            self.aligned = (not cut and not self.blk_axes) or (
                cut == [0] and S.cut_axes(pspec[0], train=True)
                == self.blk_axes and local % BLOCK == 0)
        else:
            last = pspec[-1] if pspec else None
            self.last_axes = S.cut_axes(last, train=True)
            self.parts = getattr(last, "parts", 1)
            width = self.local_shape[-1] if self.shape else 1
            self.aligned = self.parts == 1 and (
                not self.last_axes or (self.last_axes == self.blk_axes
                                       and width % BLOCK == 0))
        self.received = 0

    def _q_shape(self):
        lead = () if self.flat else self.local_shape[:-1]
        return (*lead, self.b1 - self.b0, BLOCK)

    def zeros(self, device):
        """The rank's blocks of a zero moment (``quantize`` of zeros)."""
        q = torch.zeros(self._q_shape(), dtype=torch.int8, device=device)
        scale = torch.full((*q.shape[:-1], 1), 1e-12, dtype=torch.float32,
                           device=device)
        return QTensor(q, scale, self.shape)

    def _gathered(self, x, axes, dim):
        out = self.dist.comm.all_gather(x, axes, dim=dim)
        self.received += (out.numel() - x.numel()) * out.element_size()
        return out

    def store(self, x):
        """The rank's f32 moment (its shard of the leaf) -> its blocks."""
        if self.aligned:
            t = quantize_flat(x) if self.flat else quantize(x)
            return QTensor(t.q, t.scale, self.shape)
        if self.flat:
            whole = S.unshard(x, self.pspec, self.dist)
            self.received += (whole.numel() - x.numel()) * 4
            t = quantize_flat(whole)
        else:
            whole = x
            if self.last_axes:
                whole = self._gathered(x.float(), self.last_axes, -1)
            if self.parts > 1:
                n = self.dist.comm.axis_size(self.last_axes)
                whole = whole.unflatten(-1, (n, self.parts, -1)).transpose(
                    -3, -2).flatten(-3)
            t = quantize(whole)
        keep = (slice(self.b0, self.b1), slice(None))
        return QTensor(t.q[(..., *keep)].contiguous(),
                       t.scale[(..., *keep)].contiguous(), self.shape)

    def load(self, t):
        """The rank's blocks -> its f32 moment (its shard of the leaf)."""
        if tuple(t.q.shape) != self._q_shape():
            raise ValueError(f"a quantized moment of q {tuple(t.q.shape)} "
                             f"where this rank's plan holds "
                             f"{self._q_shape()} (AdamW.init(..., plans=))")
        q, scale = t.q, t.scale
        if self.aligned:
            full = (q.float() * scale).reshape(*q.shape[:-2], -1)
            if self.flat:
                n = math.prod(self.local_shape)
                return full[:n].reshape(self.local_shape)
            return full[..., :self.local_shape[-1]]
        dim = 0 if self.flat else -2
        if self.blk_axes:
            q = self._gathered(q, self.blk_axes, dim)
            scale = self._gathered(scale, self.blk_axes, dim)
        full = (q.float() * scale).reshape(*q.shape[:-2], -1)
        if self.flat:
            whole = full[:math.prod(self.shape)].reshape(self.shape)
            return S.shard_params(whole, self.pspec, self.dist, train=True)
        full = full[..., :self.shape[-1]]
        n = self.dist.comm.axis_size(self.last_axes)
        i = self.dist.comm.axis_index(self.last_axes)
        size = self.shape[-1] // (n * self.parts)
        return torch.cat([full[..., (p * n + i) * size:(p * n + i + 1) * size]
                          for p in range(self.parts)], dim=-1)


def moment_plans(specs, shapes, dist, flat):
    """A ``MomentPlan`` for each leaf of ``specs`` (the params' training
    specs, ``sharding.param_specs``) and ``shapes`` (their full shapes)."""
    return T.map_tree(lambda spec, full: MomentPlan(tuple(full.shape), spec,
                                                    dist, flat),
                      specs, shapes)


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
