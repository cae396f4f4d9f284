"""Train-step factory: the port of ``repro.training.step``.

One step is the model's loss and its gradient by autograd (each layer
remat'ed inside ``model.loss``), microbatch gradient accumulation in
``accum_dtype``, and the optimizer's update.

On a mesh (``model.dist`` active) the step is explicit SPMD, every rank
running it on its blocks of the params and moments
(``sharding.shard_params(..., train=True)``, ``train_state_specs``) and
on the global batch, of which it takes this rank's rows.  The gradient
reaches each rank summed over `data` in one of the reference's two
forms:

* ``grad_specs`` set (the reference's ``shard_grad_accum``): the
  accumulator holds each leaf's block; the loss gathers each FSDP leaf
  over `data` at its use and the gather's backward reduce-scatters its
  gradient, every microbatch;
* ``grad_specs`` None: the FSDP leaves are gathered over `data` once,
  before the first microbatch, the accumulator holds them whole, and
  every leaf is all-reduced over `data` once, after the last, then cut
  back to this rank's block.

Either way a leaf that no `data` dim cuts ends with this rank's rows'
part of its gradient and is psum'd over `data` after the last
microbatch.  The optimizer's clip takes the global norm over the mesh
(``AdamW.update(..., mesh=)``).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.distribution import sharding as S
from repro_torch.distribution.context import NULL_CTX
from repro_torch.optim import quant


def make_train_step(model, optimizer, *, microbatches: int = 1,
                    accum_dtype=torch.float32, grad_specs=None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch`` is a dict of tensors on the params' device (on a
    mesh, the global batch, the same on every rank); ``microbatches``
    splits it on the leading dim as the reference does: (M, B/M), the
    second dim split over `data`, so that data rank d's microbatch i holds
    global rows i·B/M + d·B/(M·dp) onwards.  The gradients are summed in
    ``accum_dtype`` and divided by their count, as the reference's scan
    does.  With one microbatch the gradients keep the params' dtype, as
    ``jax.value_and_grad``'s do.  ``grad_specs``: the params' specs tree
    (``sharding.param_specs``), on a mesh the reduction's form (module
    docstring).  The optimizer updates params and state in place
    (``AdamW.update``)."""
    dist = getattr(model, "dist", NULL_CTX)      # RWKVLM, WhisperLM: none

    def step(params, opt_state, batch):
        layout = _MeshLayout(model, params, grad_specs) if dist.active \
            else None
        mbs = microbatch_rows(batch, microbatches, dist)
        work = params
        if layout is not None and grad_specs is None:
            with torch.no_grad():
                work = S.fsdp_gather(params, *layout.full, dist)
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(model, work, mbs[0])
        else:
            grads = T.map_tree(
                lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                      device=p.device), work)
            loss = torch.zeros((), dtype=torch.float32,
                               device=T.leaves(params)[0].device)
            for mb in mbs:
                l_i, _, g_i = value_and_grad(model, work, mb)
                grads = T.map_tree(lambda a, b: a + b.to(accum_dtype),
                                   grads, g_i)
                loss = loss + l_i
            grads = T.map_tree(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {}
        del work
        mesh = None
        if layout is not None:
            grads = layout.reduce(grads, params, whole=grad_specs is None)
            mesh = (dist.comm, layout.axes)
        params, opt_state, om = optimizer.update(grads, opt_state, params,
                                                 mesh=mesh)
        return params, opt_state, {**metrics, "loss": loss, **om}

    return step


def microbatch_rows(batch, microbatches, dist):
    """The batch's microbatches as this rank takes them: [{key: rows}]
    (module docstring's row order; one device: the batch cut into
    ``microbatches`` blocks)."""
    dp = dist.dp_size if dist.active else 1
    d = dist.comm.axis_index(dist.dp) if dist.active else 0
    out = []
    for i in range(microbatches):
        mb = {}
        for k, v in batch.items():
            n = v.shape[0] // microbatches
            if n * microbatches != v.shape[0] or n % dp:
                raise ValueError(f"batch {k} of {v.shape[0]} rows: not "
                                 f"{microbatches} microbatches over {dp} "
                                 f"data ranks")
            rows = n // dp
            mb[k] = v[i * n + d * rows:i * n + (d + 1) * rows]
        out.append(mb)
    return out


class _MeshLayout:
    """What the step on a mesh reads of the params: the full specs and
    shapes (``DecoderLM.layout``), each leaf's cut axes, and whether its
    blocks are the training cut's."""

    def __init__(self, model, params, grad_specs):
        dist = model.dist
        specs, shapes = model.layout()
        if grad_specs is not None:
            specs = grad_specs
        self.dist, self.full = dist, (specs, shapes)
        self.axes = S.leaf_axes(specs, dist.comm.names)
        for path, p in T.flatten(params):
            want = _local_shape(_at(shapes, path).shape, _at(specs, path),
                                dist)
            if tuple(p.shape) != want:
                raise ValueError(
                    f"param {path}: {tuple(p.shape)}, the training cut is "
                    f"{want} (sharding.shard_params(..., train=True))")

    def reduce(self, grads, params, whole):
        """The gradients summed over `data`: every leaf all-reduced and cut
        to this rank's block (``whole``: the accumulator held the FSDP
        leaves whole), or only the leaves no `data` dim cuts."""
        dist, (specs, _) = self.dist, self.full

        def red(g, p, spec, axes):
            if whole or not set(dist.dp) & set(axes):
                g = dist.comm.psum(g, dist.dp)
            if whole:
                for dim, entry in enumerate(spec):
                    if entry in dist.dp and g.shape[dim] > p.shape[dim]:
                        g = g.narrow(dim, dist.comm.axis_index(entry)
                                     * p.shape[dim], p.shape[dim])
                g = g.contiguous()
            return g

        return T.map_tree(red, grads, params, specs, self.axes)


def _local_shape(shape, spec, dist):
    out = []
    for n, entry in zip(shape, spec):
        axes = S.cut_axes(entry, train=True)
        out.append(n // dist.comm.axis_size(axes) if axes else n)
    return tuple(out)


def _at(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def train_state_specs(model, params_shapes, opt_state=None):
    """(param specs, {"m", "v", "step"} specs): the counterpart of the
    reference's ``train_state_shardings``; each moment shards as its
    param, the step whole.  Quantized moments on a mesh raise (ROADMAP
    Queue 1 item 12, point 7: their blocks of 256 along a shard's last
    dim give the reference's bits only where that dim is a multiple of
    256)."""
    pspecs = S.param_specs(model, params_shapes)
    if opt_state is not None and model.dist.active and any(
            quant.is_qtensor(v) for v in T.leaves(
                {"m": opt_state["m"], "v": opt_state["v"]},
                quant.is_qtensor)):
        raise NotImplementedError(
            "quantized AdamW moments on a mesh: ROADMAP Queue 1 item 12, "
            "point 7")
    return pspecs, {"m": pspecs, "v": pspecs, "step": ()}


def value_and_grad(model, params, batch):
    """(loss, metrics, grads) of ``model.loss`` at ``params``: the
    reference's ``jax.value_and_grad(loss_fn, has_aux=True)``.  The
    gradients are new tensors in the params' structure and dtypes; the
    params' own ``.grad`` stays untouched.  A leaf the loss does not
    reach (a hybrid period's empty MoE stack) gets zeros, as in JAX.  On
    a mesh, this rank's gradients (``make_train_step``'s docstring: a
    leaf no `data` dim cuts holds this rank's rows' part)."""
    paths = [path for path, _ in T.flatten(params)]
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in T.leaves(params)]
        loss, metrics = model.loss(_unflat(paths, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _unflat(paths, grads))


def _unflat(paths, values):
    """Nested dicts from ``/``-joined paths and their values."""
    tree: dict = {}
    for path, value in zip(paths, values):
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree
