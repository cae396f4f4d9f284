"""Parameter partition rules: TP over `model`, FSDP over `data` (the port
of ``repro.distribution.sharding``), and the cut of full parameters into
each rank's local blocks.

One rule table keyed on (path-context, leaf-name, trailing dims).  Leading
stacking dims (the stacked layers) are padded with ``None`` automatically,
so the same rule serves stacked and unstacked trees.  An axis is only used
when the dim divides the mesh axis size — otherwise that dim is
replicated (e.g. whisper's vocab 51865 on model=16).

Baseline layout:
  * 2nd (output) dim of column mats -> `model`; 1st dim of row mats ->
    `model` (Megatron pairing: one all-reduce per block).
  * the other big dim -> `data` (FSDP/ZeRO-3).
  * MoE experts -> `model` when n_experts divides it (EP), else experts
    replicated and the expert-hidden dim takes TP.
  * KV-projection heads replicated (GQA kv=8 never divides model=16).
  * 1-D vectors replicated.

Serving stores FSDP dims whole: ``shard_params`` cuts a dim over the axes
its spec names, but a dim the rules give to `data` alone stays whole on
every rank, as the reference's serving knob ``no_fsdp_experts`` keeps
expert weights.  Only `model` and full EP's ("data", "model") cut.
Training (``train=True``) cuts the `data` dims too (FSDP, ZeRO-3): each
rank stores 1/(data x model) of a leaf both axes cut, and the model
gathers a leaf whole over `data` at each use (``fsdp_gather``, inside the
checkpointed layer, so the recompute gathers again, as GSPMD does under
remat); the gather's backward sums the ranks' gradients and leaves each
its block (``collectives.py``).  ``leaf_axes`` gives the axes that cut
each leaf, which the gradient's reduction and the clip's global norm
read.  A dim that does not divide its axis stays whole, as the rules
say (minicpm-2b's vocab 122753 on `model`).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.distribution.context import MeshContext


def _axis_size(dist, name):
    return dist.axis_size(name) if dist.active else 1


def make_rules(model):
    cfg, dist = model.cfg, model.dist
    tp = _axis_size(dist, "model") if dist.active else 1
    fsdp = _axis_size(dist, "data") if dist.active else 1

    def m(n):          # shard over `model` when divisible
        return "model" if (dist.active and n % tp == 0 and n >= tp) else None

    def d(n):          # shard over `data` (FSDP) when divisible
        return "data" if (dist.active and n % fsdp == 0 and n >= fsdp) else \
            None

    heads = "model" if getattr(model, "shard_heads", False) else None
    moe_ep = getattr(model, "moe_ep", False)
    full_ep = (getattr(model, "moe_full_ep", False)
               and getattr(model, "full_ep_available", lambda: False)())
    if getattr(model, "no_fsdp_experts", False):
        # serving layout: expert weights fit HBM sharded over `model`
        # alone; dropping the `data` shard removes the per-layer weight
        # all-gathers at decode
        d_expert = lambda n: None
    else:
        d_expert = None

    def rule(keys, shape):
        name = keys[-1]
        core = None

        def in_ctx(*ks):
            return any(k in keys for k in ks)

        if name == "tokens":
            core = (m(shape[-2]), d(shape[-1]))
        elif name == "lm_head":
            core = (d(shape[-2]), m(shape[-1]))
        elif name == "scale" or len(shape) == 1:
            core = (None,) * min(1, len(shape))
        elif in_ctx("tm"):                      # rwkv time mix
            core = {
                "wr": (d(shape[-2]), m(shape[-1])),
                "wk": (d(shape[-2]), m(shape[-1])),
                "wv": (d(shape[-2]), m(shape[-1])),
                "wg": (d(shape[-2]), m(shape[-1])),
                "wo": (m(shape[-2]), d(shape[-1])),
                "decay_w2": (None, m(shape[-1])),
                "mix_w2": (None, None, m(shape[-1])),
                "mu": (None, None),
            }.get(name, (None,) * 2)
        elif in_ctx("cm"):                      # rwkv channel mix
            core = {
                "wk": (d(shape[-2]), m(shape[-1])),
                "wv": (m(shape[-2]), d(shape[-1])),
                "wr": (d(shape[-2]), m(shape[-1])),
            }.get(name, (None, None))
        elif in_ctx("mamba") or (cfg.mamba is not None
                                 and name in ("in_proj", "conv_w", "x_proj",
                                              "dt_proj", "A_log",
                                              "out_proj")):
            core = {
                "in_proj": (d(shape[-2]), m(shape[-1])),
                "conv_w": (None, m(shape[-1])),
                "x_proj": (m(shape[-2]), None),
                "dt_proj": (None, m(shape[-1])),
                "A_log": (m(shape[-2]), None),
                "out_proj": (m(shape[-2]), d(shape[-1])),
            }.get(name, (None,) * 2)
        elif name in ("gate", "up", "down") and cfg.moe is not None \
                and "shared" not in keys and "mlp" not in keys \
                and ("moe" in keys or
                     ("ffn" in keys and cfg.layer_is_moe(0))):
            # stacked expert weights (E, d, f) — EP over `model` when E
            # divides it, else hidden-dim TP
            if full_ep:
                core = (("data", "model"), None, None)
            else:
                de = d_expert if d_expert is not None else d
                e = "model" if moe_ep else None
                t = None if moe_ep else "model"
                if name in ("gate", "up"):
                    core = (e, de(shape[-2]),
                            t if t and shape[-1] % tp == 0 else None)
                else:
                    core = (e, t if t and shape[-2] % tp == 0 else None,
                            de(shape[-1]))
        elif name == "router":
            core = (None, None)
        elif name == "wq":
            core = (d(shape[-2]), heads)
        elif name in ("wk", "wv"):
            core = (d(shape[-2]), None)         # GQA KV replicated
        elif name == "wo":
            core = (heads, d(shape[-1]))
        elif name in ("wq_a", "wkv_a"):         # MLA down-projections
            # column-sharded over `model`; no_mla_colshard restores the
            # baseline (replicated columns)
            if getattr(model, "no_mla_colshard", False):
                core = (d(shape[-2]), None)
            else:
                core = (d(shape[-2]), m(shape[-1]))
        elif name in ("wq_b", "wk_b", "wv_b"):  # MLA up-projections (heads)
            core = (None, m(shape[-1]))
        elif name in ("gate", "up"):            # dense MLP
            core = (d(shape[-2]), m(shape[-1]))
        elif name == "down":
            core = (m(shape[-2]), d(shape[-1]))
        elif name == "proj":                    # mtp projection
            core = (d(shape[-2]), m(shape[-1]))
        else:
            core = (None,) * min(2, len(shape))

        pad = (None,) * (len(shape) - len(core))
        return pad + tuple(core)

    return rule


def param_specs(model, param_shapes):
    """param_shapes: a nested dict whose leaves have ``.shape`` (tensors,
    meta tensors) -> the same nested dict of specs."""
    rule = make_rules(model)

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        return rule(keys, tuple(node.shape))

    return walk(param_shapes, ())


def batch_specs(dist: MeshContext, batch_shapes, shard_batch=True):
    dp = dist.batch_axes() if shard_batch else None

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return (dp,) + (None,) * (len(node.shape) - 1)

    return walk(batch_shapes)


def cut_axes(entry, train=False):
    """The axes a spec entry cuts its dim over: none for None, and for
    `data` alone (FSDP) unless ``train``: serving stores it whole."""
    if entry is None or (entry == "data" and not train):
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_params(params, specs, dist: MeshContext, train: bool = False):
    """Each full parameter of ``params`` cut to this rank's block by its
    spec in ``specs`` (``param_specs``' tree): a dim whose entry names
    `model` (or ("data", "model"), or with ``train`` `data` too) is cut
    into equal blocks over those axes, the rank's block at its flattened
    index; other dims stay whole.  A cut leaf is a contiguous copy (the
    full tree can be freed); a leaf that nothing cuts is the full one."""
    def cut(t, spec):
        out = t
        for dim, entry in enumerate(spec):
            axes = cut_axes(entry, train)
            if not axes:
                continue
            n = dist.comm.axis_size(axes)
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"divide over {axes} ({n})")
            size = t.shape[dim] // n
            out = out.narrow(dim, dist.comm.axis_index(axes) * size, size)
        return out if out is t else out.clone(
            memory_format=torch.contiguous_format)

    return T.map_tree(cut, params, specs)


def leaf_axes(specs, names):
    """Each leaf's tuple of the mesh axes that cut it (in mesh order
    ``names``; () for a leaf every rank holds whole), as ``shard_params``
    with ``train`` cuts them."""
    def axes(spec):
        cut = {a for entry in spec for a in cut_axes(entry, train=True)}
        return tuple(a for a in names if a in cut)

    return T.map_tree(axes, specs)


def fsdp_gather(tree, specs, shapes, dist: MeshContext, lead: int = 0):
    """``tree``'s leaves whole over `data`: each dim whose spec entry is
    `data` and which this rank holds a block of (smaller than in
    ``shapes``, the full shapes) all-gathered over `data`, with the
    gather's backward (a reduce-scatter of the gradient); ``shapes``' leaves
    have ``.shape`` (``DecoderLM.layout``'s meta tensors).  ``lead``: the
    leading entries of the specs and shapes that ``tree`` lacks (a layer's
    views of stacked leaves drop the layer dim)."""
    def gather(t, spec, full):
        for dim, entry in enumerate(spec[lead:]):
            if entry == "data" and t.shape[dim] < full.shape[lead + dim]:
                t = dist.comm.all_gather(t, "data", dim=dim)
        return t

    return T.map_tree(gather, tree, specs, shapes)
