"""AdamW with global-norm clipping; moments optionally int8-quantized.
The port of ``repro.optim.adamw``.

Functions over nested dicts of tensors, as the reference's over pytrees.
Every step is the reference's f32 arithmetic in its order: the clip's sum
of squares over the leaves in the reference's leaf order, the bias
corrections ``1 - b ** step`` as f32 tensor operations (the reference's
Python floats are weakly typed f32 there), decay only on leaves with
``ndim >= 2`` (the stacked (L, d) norm scales included).  With
``quantized=True`` the moments are ``quant.QTensor``s, shape-preserving
or (``flat_moments``) flat.

Unlike the reference, ``update`` writes the new params and unquantized
moments into the tensors it was given (and returns them): at minicpm-2b's
2.7 B params a second copy would cost 5.4 GB of params and 21.8 GB of
moments.  It runs under ``torch.no_grad``.

On a mesh (``update(..., mesh=(comm, axes))``, ``training/step.py``)
each rank updates its blocks, and the clip's global norm is the whole
model's: each leaf's sum of squares is psum'd over the axes that cut it
(one psum for the leaves of each set of axes) and a leaf every rank
holds whole counts once, so ``grad_norm`` and the clip scale are the
one-device run's (up to the order of the sums).  Decay's ``ndim >= 2``
rule reads a block's ndim, which is its global shape's: a cut keeps
every dim.  Quantized moments raise there (ROADMAP Queue 1 item 12,
point 7).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree as T
from repro_torch.optim import quant


class AdamWConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantized: bool = False
    flat_moments: bool = False      # original (baseline) QTensor layout


class AdamW:
    def __init__(self, schedule_fn, cfg: AdamWConfig = AdamWConfig()):
        self.schedule = schedule_fn
        self.cfg = cfg

    def init(self, params):
        """Zero moments (f32, or quantized) and step 0 (int32), on the
        params' device."""
        def zero_like(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return self._store(z)
        device = T.leaves(params)[0].device
        return {"m": T.map_tree(zero_like, params),
                "v": T.map_tree(zero_like, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def _load(self, t):
        return quant.dequantize(t) if self.cfg.quantized else t

    def _store(self, t):
        if not self.cfg.quantized:
            return t
        return (quant.quantize_flat(t) if self.cfg.flat_moments
                else quant.quantize(t))

    @torch.no_grad()
    def update(self, grads, state, params, mesh=None):
        """(params, state, {"grad_norm", "lr"}) after one step; params and
        unquantized moments are updated in place.  ``mesh``: (the mesh's
        ``Collectives``, each leaf's cut axes) on a mesh."""
        c = self.cfg
        if mesh is not None and c.quantized:
            raise NotImplementedError(
                "quantized AdamW moments on a mesh: ROADMAP Queue 1 item "
                "12, point 7")
        step = state["step"] + 1
        lr = self.schedule(step)
        flat_g = T.leaves(grads)

        # global-norm clip (f32 accumulation, in the reference's leaf order)
        gnorm = torch.sqrt(global_square_sum(flat_g, mesh))
        scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        stepf = step.float()
        b1c = 1 - torch.full_like(stepf, c.b1) ** stepf
        b2c = 1 - torch.full_like(stepf, c.b2) ** stepf

        def upd(p, g, m_q, v_q):
            g = g.float() * scale
            m = c.b1 * self._load(m_q) + (1 - c.b1) * g
            v = c.b2 * self._load(v_q) + (1 - c.b2) * torch.square(g)
            del g
            u = (m / b1c) / (torch.sqrt(v / b2c) + c.eps)
            if p.dim() >= 2:                     # decay matrices only
                u = u + c.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
            return p, self._keep(m_q, m), self._keep(v_q, v)

        is_q = quant.is_qtensor
        out = [upd(p, g, m, v) for p, g, m, v in zip(
            T.leaves(params), flat_g, T.leaves(state["m"], is_q),
            T.leaves(state["v"], is_q))]
        new_m = _unflatten(state["m"], [o[1] for o in out], is_q)
        new_v = _unflatten(state["v"], [o[2] for o in out], is_q)
        return params, {"m": new_m, "v": new_v, "step": step}, {
            "grad_norm": gnorm, "lr": lr}

    def _keep(self, old, new):
        """The stored moment: ``new`` quantized, or written into ``old``."""
        if self.cfg.quantized:
            return self._store(new)
        return old.copy_(new)


def global_square_sum(flat_g, mesh=None):
    """The sum of squares of every gradient leaf (f32, in leaf order); on
    a mesh (``(comm, axes tree)``) the whole model's: the leaves grouped
    by the axes that cut them, each group's local sum psum'd over its
    axes, the groups in the order their first leaves come."""
    if mesh is None:
        return sum(torch.sum(torch.square(g.float())) for g in flat_g)
    comm, axes = mesh
    groups = {}
    for g, ax in zip(flat_g, T.leaves(axes)):
        s = torch.sum(torch.square(g.float()))
        groups[ax] = groups[ax] + s if ax in groups else s
    return sum(comm.psum(s, ax) for ax, s in groups.items())


def _unflatten(tree, values, is_leaf):
    """``values`` in ``tree``'s structure (leaves in sorted key order)."""
    it = iter(values)

    def build(node):
        if not is_leaf(node) and isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)
