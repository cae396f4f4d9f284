"""Weight bridge between the reference's param pytree, flattened to numpy
arrays, and the port's dict of tensors, both ways; AdamW's state too.

The flat form is ``{path: array}`` keyed by the ``/``-joined paths of the
reference's checkpoint flattening (``layers/attn/wq``, ``embed/tokens``,
``m/layers/attn/wq/0`` for a quantized moment's payload, ``step``).
Shapes are kept as they are: the stacked (L, ...) layer dim and the
``x @ W`` (d_in, d_out) orientation are the same in both packages.  bf16
crosses bit-exactly through a 16-bit integer view, never through float32:
in, from ``ml_dtypes.bfloat16`` arrays; out, to them (``ml_dtypes`` is
imported only there, by the caller that wants the reference's arrays).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.optim.quant import QTensor


def to_tensor(arr: np.ndarray, device="cpu") -> torch.Tensor:
    arr = np.require(arr, requirements=["C", "W"])
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as the reference holds it: bf16 as ``ml_dtypes.bfloat16``
    through an int16 view, other dtypes as numpy's."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_flat(flat: Dict[str, np.ndarray], device="cpu") -> dict:
    """``{"layers/attn/wq": array, ...}`` -> nested dict of tensors."""
    tree: dict = {}
    for path, arr in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = to_tensor(arr, device)
    return tree


def flat_from_params(tree) -> Dict[str, np.ndarray]:
    """A nested dict of tensors (params, or AdamW's state, whose
    ``QTensor`` moments give ``.../0`` and ``.../1``) -> ``{path:
    array}``, the reference's flattening."""
    return {path: to_numpy(leaf) for path, leaf in T.flatten(tree)}


def opt_state_from_flat(flat: Dict[str, np.ndarray], params,
                        device="cpu") -> dict:
    """The reference's AdamW state, flattened, -> the port's: ``m`` and
    ``v`` in ``params``' structure (quantized moments as ``QTensor``s of
    their param's shape) and ``step``."""
    tree = params_from_flat(flat, device)

    def moments(node, like):
        if isinstance(like, dict):
            return {k: moments(node[k], v) for k, v in like.items()}
        if isinstance(node, dict):       # a QTensor's q ("0"), scale ("1")
            return QTensor(node["0"], node["1"], tuple(like.shape))
        return node

    return {"m": moments(tree["m"], params), "v": moments(tree["v"], params),
            "step": tree["step"]}
