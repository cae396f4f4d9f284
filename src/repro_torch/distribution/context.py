"""Mesh/axis context threaded through model constructors: the port of
``repro.distribution.context``.

``MeshContext`` is the one handle models need: which mesh, which axes
carry data parallelism (the batch), which axis carries model parallelism
and which axes shard the KV cache's sequence dim.  The mesh is a
``torch.distributed`` ``DeviceMesh`` with named dims; ``NULL_CTX`` is the
one-device context.

The port runs a mesh as explicit SPMD: every rank holds plain local
tensors (its shard of each parameter, ``sharding.shard_params``; its rows
of the batch; its slots of the cache), and the models call the
collectives of ``collectives.py`` where the reference's GSPMD inserts
them.  A spec is a tuple with one entry per dim: ``None`` (whole), an
axis name, or a tuple of axis names, the counterpart of ``PartitionSpec``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.distribution.collectives import Collectives


@dataclass
class MeshContext:
    mesh: Optional[object] = None        # a DeviceMesh (or names and sizes)
    dp: Tuple[str, ...] = ("data",)      # axes carrying the batch dim
    tp: str = "model"                    # tensor/expert-parallel axis
    kv_seq: Tuple[str, ...] = ("model",)  # axes sharding KV-cache seq dim
    comm: Optional[Collectives] = None   # the mesh's collectives

    @property
    def active(self) -> bool:
        return self.mesh is not None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names) if self.active else ()

    def axis_size(self, name: str) -> int:
        """The size of mesh dim ``name``; 1 for a dim the mesh lacks, as
        the reference's ``mesh.shape.get(name, 1)``."""
        if name not in self.axis_names:
            return 1
        return int(self.mesh.shape[self.axis_names.index(name)])

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp) if self.active else 1

    @property
    def dp_size(self) -> int:
        if not self.active:
            return 1
        n = 1
        for a in self.dp:
            n *= self.axis_size(a)
        return n

    def wsc(self, x, *parts):
        """The reference's ``with_sharding_constraint``: the identity here,
        on a mesh too.  Under explicit SPMD a tensor is already the rank's
        local block and every collective is written out where GSPMD would
        insert it, so there is no layout left to constrain."""
        return x

    def batch_axes(self):
        """Mesh-axis tuple for the batch dim of activations (None when the
        batch dim is unshardable, e.g. long_500k batch=1)."""
        if not self.dp:
            return None
        return self.dp if len(self.dp) > 1 else self.dp[0]

    def kv_axes(self):
        """Mesh axes for the KV-cache sequence dim (flash-decoding SP)."""
        if not self.kv_seq:
            return None
        return self.kv_seq if len(self.kv_seq) > 1 else self.kv_seq[0]


NULL_CTX = MeshContext(mesh=None)


def make_context(mesh, *, shard_batch: bool = True,
                 kv_seq: Optional[Tuple[str, ...]] = None,
                 comm: Optional[Collectives] = None) -> MeshContext:
    """The reference's axis rules over ``mesh.mesh_dim_names``.  ``comm``
    is the mesh's ``Collectives`` (``launch/mesh.py::make_smoke_mesh``
    returns both); a context without it knows names and sizes only, which
    is all the rule table and the specs read."""
    if mesh is None:
        return MeshContext(mesh=None)
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in names if a in ("pod", "data", "replica"))
    if not shard_batch:
        dp = ()
    return MeshContext(mesh=mesh, dp=dp or ((names[0],) if shard_batch
                                            else ()),
                       tp="model" if "model" in names else names[-1],
                       kv_seq=kv_seq or ("model",), comm=comm)
