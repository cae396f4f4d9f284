"""Collectives over named mesh dims: the counterparts of ``jax.lax.psum``,
``pmax``, ``pmean``, ``psum_scatter``, ``all_gather(..., tiled=True)``,
``ppermute`` and ``axis_index``, over one dim of a ``DeviceMesh`` or
several, each with a backward.

Several dims act as one flattened dim in the reference's order: the
rank's index over ("data", "model") is ``data_index * model_size +
model_index`` (``src/repro/models/attention.py:345-347``), and a tiled
all-gather over them concatenates the ranks' blocks in that order.  A
``DeviceMesh`` has a process group for each dim only, so ``Collectives``
makes one for every set of two or more dims, in mesh order, when it is
built; every rank of the mesh must build it, at the same point.  Axes are
named in mesh order (a flattened index in another order would not be the
group's rank order, which a gathered block's position follows).

Gradients.  Training on a mesh is explicit SPMD: each rank
differentiates its own copy of the program, and the collectives carry
the gradient across ranks by one convention for each kind of axis:

* ``model`` (and any axis but the batch axes): a value that every rank
  of the axis holds whole holds its whole gradient on every rank.  So
  ``psum``'s backward is the identity, and a tiled ``all_gather``'s
  backward takes the rank's own block of the gradient.  Where such a
  value (an activation or a parameter) enters a computation split over
  the axis (a column-split product, a norm scale applied to local heads,
  a row slice of a weight held whole), ``enter`` marks it: the identity
  forward, a psum of the ranks' partial gradients backward.
* the batch axes ``BATCH_AXES`` ("pod", "data", "replica": the batch is
  split over them): each rank's rows give a part of every gradient.  A
  tiled ``all_gather`` over them (FSDP's gather of a weight at its use)
  has a ``psum_scatter`` backward: the ranks' parts summed, each rank
  keeping its block.  A parameter that no batch axis cuts ends with a
  part on each rank, which the train step sums (``training/step.py``).
  The loss's ``psum`` over them has the identity backward: every rank's
  rows get the gradient of the global loss.
* ``pmean`` is ``psum`` divided by the axes' size, forward and
  backward; ``psum_scatter``'s backward is a tiled ``all_gather``;
  ``ppermute``'s is the inverse permutation's ``ppermute``; ``pmax`` has
  no gradient (where it steadies a softmax, the result does not depend
  on it).

The backward runs on autograd's thread, and under
``torch.utils.checkpoint`` the recompute issues the forward's
collectives again: every rank runs the same graph, so every rank issues
them in the same order.

Staging through host memory: a gloo group takes CPU tensors, and some of
its operations refuse CUDA ones.  Whether to stage is decided once, when
``Collectives`` is built, from the mesh's backend and device type: on a
gloo mesh over CUDA every operation copies its operand to host memory,
runs there and copies the result back to the operand's device; on any
other mesh (NCCL over CUDA, gloo over the CPU) operands go to the backend
as they are.  Nothing here is decided by catching a failure.

Every call adds the bytes it moved to ``bytes_by_op``, one to
``calls_by_op`` and its seconds to ``seconds_by_op``, under the op the
backend ran: an all-reduce (psum, pmax, pmean) counts its operand's bytes
("psum", "pmax"), an all-gather its gathered result's, a reduce-scatter
("psum_scatter") its operand's, a ``ppermute`` the bytes it sent.  A
backward's collective counts as the op it runs.  The seconds are the
host clock's from the operand's copy to the result's arrival on the
operand's device; ``staging_seconds`` sums the copies' share of them.
Staged, the copies wait for the card, so the seconds are the
collective's whole cost; over NCCL they time the enqueue only.
``reset()`` zeroes them all.
"""
from __future__ import annotations

import itertools
import math
import time
from typing import Dict, Iterable, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[None, str, Iterable[str]]

OPS = ("psum", "pmax", "all_gather", "psum_scatter", "ppermute")
BATCH_AXES = ("pod", "data", "replica")


class Collectives:
    """The collectives of one ``DeviceMesh``, from this rank's side."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names: Tuple[str, ...] = tuple(mesh.mesh_dim_names)
        self.backend = dist.get_backend(mesh.get_group(self.names[0]))
        self.stage = self.backend == "gloo" and mesh.device_type == "cuda"
        self._groups = {(a,): mesh.get_group(a) for a in self.names}
        ranks = mesh.mesh
        for n in range(2, len(self.names) + 1):
            for dims in itertools.combinations(range(len(self.names)), n):
                rest = [d for d in range(ranks.dim()) if d not in dims]
                blocks = ranks.permute(*rest, *dims).reshape(
                    -1, math.prod(ranks.shape[d] for d in dims))
                group, _ = dist.new_subgroups_by_enumeration(
                    blocks.tolist(), backend=self.backend)
                self._groups[tuple(self.names[d] for d in dims)] = group
        for axes, group in self._groups.items():
            if dist.get_rank(group) != self.axis_index(axes):
                raise ValueError(
                    f"group {axes}: rank {dist.get_rank(group)} is not the "
                    f"flattened mesh index {self.axis_index(axes)} (a mesh "
                    f"whose ranks are not in row-major order)")
        self.bytes_by_op: Dict[str, int] = {}
        self.calls_by_op: Dict[str, int] = {}
        self.seconds_by_op: Dict[str, float] = {}
        self.reset()

    def reset(self):
        for op in OPS:
            self.bytes_by_op[op] = 0
            self.calls_by_op[op] = 0
            self.seconds_by_op[op] = 0.0
        self.staging_seconds = 0.0

    # ------------------------------------------------------------- indices

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [self.names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} are not in mesh order "
                             f"{self.names}")
        return axes

    def axis_size(self, axes: Axes) -> int:
        n = 1
        for a in self._axes(axes):
            n *= self.mesh.size(self.names.index(a))
        return n

    def axis_index(self, axes: Axes) -> int:
        """This rank's index over ``axes``, flattened in the reference's
        order (0 for no axes)."""
        idx = 0
        for a in self._axes(axes):
            idx = (idx * self.mesh.size(self.names.index(a))
                   + self.mesh.get_local_rank(a))
        return idx

    # --------------------------------------------------------- collectives

    def psum(self, x, axes: Axes):
        return _apply(_Psum, x, self, self._axes(axes))

    def pmax(self, x, axes: Axes):
        """No gradient: the result is detached."""
        axes = self._axes(axes)
        if not axes:
            return x.detach()
        return self._all_reduce("pmax", x, axes, dist.ReduceOp.MAX)

    def pmean(self, x, axes: Axes):
        return self.psum(x, axes) / self.axis_size(axes)

    def enter(self, x, axes: Axes):
        """``x`` itself; its gradient summed over ``axes`` in the backward
        (a value every rank holds whole, entering a computation split
        over ``axes``: module docstring)."""
        return _apply(_Enter, x, self, self._axes(axes))

    def all_gather(self, x, axes: Axes, dim: int):
        """The ranks' blocks of ``x`` over ``axes`` concatenated along
        ``dim`` in flattened-index order (``all_gather(tiled=True)``).
        Backward: over the batch axes a ``psum_scatter``, over the others
        the rank's own block (module docstring)."""
        return _apply(_AllGather, x, self, self._axes(axes), dim % x.dim())

    def psum_scatter(self, x, axes: Axes, dim: int):
        """The sum over ``axes`` of ``x``, cut along ``dim`` into equal
        blocks, this rank's block at its flattened index
        (``psum_scatter(scatter_dimension=dim, tiled=True)``)."""
        return _apply(_PsumScatter, x, self, self._axes(axes), dim % x.dim())

    def ppermute(self, x, axes: Axes, perm: Sequence[Tuple[int, int]]):
        """``jax.lax.ppermute``: for each (i, j) of ``perm`` (flattened
        indices over ``axes``), rank i's ``x`` goes to rank j; a rank that
        no pair sends to gets zeros."""
        return _apply(_Ppermute, x, self, self._axes(axes),
                      tuple((int(i), int(j)) for i, j in perm))

    # ------------------------------------------------ the backend's calls

    def _run(self, op, x, call):
        """``call`` (the backend's operation) on a contiguous copy of ``x``
        (in host memory when staging), which it may work on in place; it
        returns (the result, the tensor whose bytes count).  The result
        goes back to ``x``'s device.  Counts the call, its bytes, its
        seconds on the host clock from the operand's copy to the result's,
        and of those the copies' (``staging_seconds``)."""
        t0 = time.perf_counter()
        y = x.detach().to("cpu" if self.stage else x.device, copy=True,
                          memory_format=torch.contiguous_format)
        t1 = time.perf_counter()
        out, counted = call(y)
        t2 = time.perf_counter()
        out = out.to(x.device)
        t3 = time.perf_counter()
        self.bytes_by_op[op] += counted.numel() * counted.element_size()
        self.calls_by_op[op] += 1
        self.seconds_by_op[op] += t3 - t0
        self.staging_seconds += (t1 - t0) + (t3 - t2)
        return out

    def _all_reduce(self, op, x, axes, reduce_op):
        def call(y):
            dist.all_reduce(y, op=reduce_op, group=self._groups[axes])
            return y, y

        return self._run(op, x, call)

    def _all_gather(self, x, axes, dim):
        def call(y):
            parts = [torch.empty_like(y)
                     for _ in range(self.axis_size(axes))]
            dist.all_gather(parts, y, group=self._groups[axes])
            out = torch.cat(parts, dim=dim)
            return out, out

        return self._run("all_gather", x, call)

    def _psum_scatter(self, x, axes, dim):
        n = self.axis_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {axes} ({n})")

        def call(y):
            out = y.new_empty((y.shape[0] // n, *y.shape[1:]))
            dist.reduce_scatter_tensor(out, y, group=self._groups[axes])
            return out, y

        return self._run("psum_scatter", x.movedim(dim, 0),
                         call).movedim(0, dim)

    def _ppermute(self, x, axes, perm):
        group = self._groups[axes]
        me = self.axis_index(axes)

        def call(y):
            out = torch.zeros_like(y)
            ops, sent = [], y[:0]
            for i, j in perm:
                if i == j == me:
                    out.copy_(y)
                elif i == me:
                    ops.append(dist.P2POp(dist.isend, y,
                                          dist.get_global_rank(group, j),
                                          group=group))
                    sent = y
                elif j == me:
                    ops.append(dist.P2POp(dist.irecv, out,
                                          dist.get_global_rank(group, i),
                                          group=group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return out, sent

        return self._run("ppermute", x, call)

    def _own_block(self, g, axes, dim):
        n = g.shape[dim] // self.axis_size(axes)
        return g.narrow(dim, self.axis_index(axes) * n, n)


def _apply(fn, x, comm, axes, *args):
    return fn.apply(x, comm, axes, *args) if axes else x


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        return comm._all_reduce("psum", x, axes, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.psum(g, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.comm, ctx.axes, ctx.dim = comm, axes, dim
        return comm._all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        batch = [a in BATCH_AXES for a in ctx.axes]
        if all(batch):
            dx = ctx.comm.psum_scatter(g, ctx.axes, ctx.dim)
        elif not any(batch):
            dx = ctx.comm._own_block(g, ctx.axes, ctx.dim)
        else:
            raise ValueError(f"a gather over {ctx.axes} mixes batch and "
                             f"other axes: its gradient has no convention")
        return dx, None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.comm, ctx.axes, ctx.dim = comm, axes, dim
        return comm._psum_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.axes, ctx.dim), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, perm):
        ctx.comm, ctx.axes, ctx.perm = comm, axes, perm
        return comm._ppermute(x, axes, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((j, i) for i, j in ctx.perm)
        return ctx.comm.ppermute(g, ctx.axes, inverse), None, None, None
