"""GPipe-style microbatch pipeline over a mesh axis: the port of
``repro.training.pipeline``, as explicit SPMD on ``collectives.py``.

Stage s holds its layers (this rank's block of stage params whose leading
stage dim is cut over the axis); microbatches stream through the ring
with one ``ppermute`` a tick; the last stage's outputs are psum'd to
every rank.  Forward only, as the reference: a training pipeline would
compose a backward per microbatch (1F1B) on the same ring transport.
The bubble is the standard (S-1)/(M+S-1).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def gpipe_forward(stage_fn, stage_params, microbatches, *, comm,
                  axis: str = "stage"):
    """Runs ``microbatches`` (M, mb, ...) through the S stages of
    ``axis`` (S its size) and returns the (M, mb, ...) outputs on every
    rank.  ``stage_params``: this rank's block of a tree whose leaves
    have a leading stage dim (size 1 here); ``stage_fn(params_one_stage,
    x) -> y`` with ``y.shape == x.shape`` (homogeneous stages)."""
    n_stages = comm.axis_size(axis)
    n_mb = microbatches.shape[0]
    sid = comm.axis_index(axis)
    mine = T.map_tree(lambda a: a[0], stage_params)
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    buf = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(n_mb + n_stages - 1):       # fill, steady, drain
        # stage 0 injects microbatch t while t < M
        x = microbatches[min(t, n_mb - 1)] if sid == 0 else buf
        y = stage_fn(mine, x)
        buf = comm.ppermute(y, axis, ring)
        # the last stage completes microbatch t - (S - 1) at tick t
        if t >= n_stages - 1 and sid == n_stages - 1:
            outs[t - (n_stages - 1)] = y
    return comm.psum(outs if sid == n_stages - 1
                     else torch.zeros_like(outs), axis)


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
