"""Where the port's entry points run: on the card unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA on a machine without one
    raises instead of quietly running on the CPU; pass ``device="cpu"``
    to run there on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return dev
