"""Collectives over named mesh dims: the counterparts of ``jax.lax.psum``,
``pmax``, ``pmean``, ``all_gather(..., tiled=True)`` and ``axis_index``,
over one dim of a ``DeviceMesh`` or several.

Several dims act as one flattened dim in the reference's order: the
rank's index over ("data", "model") is ``data_index * model_size +
model_index`` (``src/repro/models/attention.py:345-347``), and a tiled
all-gather over them concatenates the ranks' blocks in that order.  A
``DeviceMesh`` has a process group for each dim only, so ``Collectives``
makes one for every set of two or more dims, in mesh order, when it is
built; every rank of the mesh must build it, at the same point.  Axes are
named in mesh order (a flattened index in another order would not be the
group's rank order, which a gathered block's position follows).

Staging through host memory: a gloo group takes CPU tensors, and some of
its operations refuse CUDA ones.  Whether to stage is decided once, when
``Collectives`` is built, from the mesh's backend and device type: on a
gloo mesh over CUDA every operation copies its operand to host memory,
runs there and copies the result back to the operand's device; on any
other mesh (NCCL over CUDA, gloo over the CPU) operands go to the backend
as they are.  Nothing here is decided by catching a failure.

Every call adds the bytes it moved to ``bytes_by_op`` (and one to
``calls_by_op``): an all-reduce (psum, pmax, pmean) counts its operand's
bytes, an all-gather its gathered result's.  ``reset()`` zeroes both.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[None, str, Iterable[str]]

OPS = ("psum", "pmax", "all_gather")


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
        self.reset()

    def reset(self):
        for op in OPS:
            self.bytes_by_op[op] = 0
            self.calls_by_op[op] = 0

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

    def _operand(self, x):
        """A contiguous copy of ``x`` to run the operation on (in place):
        in host memory when staging."""
        return x.detach().to("cpu" if self.stage else x.device, copy=True,
                             memory_format=torch.contiguous_format)

    def _count(self, op, t):
        self.bytes_by_op[op] += t.numel() * t.element_size()
        self.calls_by_op[op] += 1

    def _all_reduce(self, op, x, axes, reduce_op):
        axes = self._axes(axes)
        if not axes:
            return x
        y = self._operand(x)
        dist.all_reduce(y, op=reduce_op, group=self._groups[axes])
        self._count(op, y)
        return y.to(x.device)

    def psum(self, x, axes: Axes):
        return self._all_reduce("psum", x, axes, dist.ReduceOp.SUM)

    def pmax(self, x, axes: Axes):
        return self._all_reduce("pmax", x, axes, dist.ReduceOp.MAX)

    def pmean(self, x, axes: Axes):
        return self.psum(x, axes) / self.axis_size(axes)

    def all_gather(self, x, axes: Axes, dim: int):
        """The ranks' blocks of ``x`` over ``axes`` concatenated along
        ``dim`` in flattened-index order (``all_gather(tiled=True)``)."""
        axes = self._axes(axes)
        if not axes:
            return x
        y = self._operand(x)
        parts = [torch.empty_like(y) for _ in range(self.axis_size(axes))]
        dist.all_gather(parts, y, group=self._groups[axes])
        out = torch.cat(parts, dim=dim)
        self._count("all_gather", out)
        return out.to(x.device)
