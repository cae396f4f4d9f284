"""Mesh construction for the port: the counterpart of
``repro.launch.mesh``.

A function, not a module constant: importing this module starts no
process group.  The reference's ``make_production_mesh`` (a TPU pod's
(16, 16) or (2, 16, 16) chips) and its roofline constants are TPU numbers
(v5e peak flops, HBM and ICI rates, HBM size): they have no counterpart
here.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_smoke_mesh(shape=(1, 1), axes=("data", "model"), *, device_type,
                    backend, store, rank):
    """Joins this process, as ``rank``, to a process group of
    ``prod(shape)`` ranks on ``backend`` ("nccl" with one card a rank;
    "gloo" over the CPU, or for several ranks sharing one card, which
    NCCL refuses) rendezvousing through ``store`` (a ``FileStore``: no
    port to pick), and returns the ``DeviceMesh`` of ``device_type`` with
    dims ``axes``.  Every rank calls it with the same arguments but
    ``rank``."""
    dist.init_process_group(backend=backend, store=store, rank=rank,
                            world_size=math.prod(shape))
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
