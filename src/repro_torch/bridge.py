"""Weight bridge: the reference's param pytree, flattened to numpy arrays,
into the port's dict of tensors.

The input is ``{path: array}`` keyed by the ``/``-joined paths of the
reference's checkpoint flattening (``layers/attn/wq``, ``embed/tokens``,
...).  Shapes are kept as they are: the stacked (L, ...) layer dim and the
``x @ W`` (d_in, d_out) orientation are the same in both packages.  bf16
arrives as ``ml_dtypes.bfloat16`` and crosses bit-exactly through a
16-bit integer view, never through float32.  Only numpy is needed here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_tensor(arr: np.ndarray, device="cpu") -> torch.Tensor:
    arr = np.require(arr, requirements=["C", "W"])
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


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
