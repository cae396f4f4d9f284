"""Train-step factory: the port of ``repro.training.step``.

One step is the model's loss and its gradient by autograd (each layer
remat'ed inside ``model.loss``), microbatch gradient accumulation in
``accum_dtype``, and the optimizer's update.  One device: the
reference's sharding arguments (``grad_specs``) belong to training on a
mesh, ROADMAP Queue 1 item 12's remainder (the port serves on a mesh
since its first half).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def make_train_step(model, optimizer, *, microbatches: int = 1,
                    accum_dtype=torch.float32):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch`` is a dict of tensors on the params' device;
    ``microbatches`` splits it on the leading dim, and the gradients are
    summed in ``accum_dtype`` and divided by their count, as the
    reference's scan does.  With one microbatch the gradients keep the
    params' dtype, as ``jax.value_and_grad``'s do.  The optimizer updates
    params and state in place (``AdamW.update``)."""

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(model, params, batch)
        else:
            mbs = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                + tuple(v.shape[1:]))
                   for k, v in batch.items()}
            grads = T.map_tree(
                lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                      device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=T.leaves(params)[0].device)
            for i in range(microbatches):
                l_i, _, g_i = value_and_grad(
                    model, params, {k: v[i] for k, v in mbs.items()})
                grads = T.map_tree(lambda a, b: a + b.to(accum_dtype),
                                   grads, g_i)
                loss = loss + l_i
            grads = T.map_tree(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {}
        params, opt_state, om = optimizer.update(grads, opt_state, params)
        return params, opt_state, {**metrics, "loss": loss, **om}

    return step


def value_and_grad(model, params, batch):
    """(loss, metrics, grads) of ``model.loss`` at ``params``: the
    reference's ``jax.value_and_grad(loss_fn, has_aux=True)``.  The
    gradients are new tensors in the params' structure and dtypes; the
    params' own ``.grad`` stays untouched.  A leaf the loss does not
    reach (a hybrid period's empty MoE stack) gets zeros, as in JAX."""
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
