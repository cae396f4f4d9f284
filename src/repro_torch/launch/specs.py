"""Per-cell serving knobs: the port of ``repro.launch.specs``'s
``optimized_overrides``, over the port's own ``SHAPES``.  The cell
function (``build_cell``) comes with the launch tooling, ROADMAP Queue 1
item 13."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES


def optimized_overrides(arch: str, shape_name: str) -> dict:
    """Per-arch serving knobs, set as attributes of the arch's model.
    Train/prefill cells keep the defaults."""
    kind = SHAPES[shape_name].kind
    if kind == "prefill":
        # the serving layout also helps prefill for TP-mode MoE
        return ({"no_fsdp_experts": True}
                if arch == "mixtral-8x7b" else {})
    if kind != "decode":
        return {}
    ov = {"sp_decode": True}
    if arch in ("mixtral-8x7b", "h2o-danube-3-4b"):
        ov["window_cache"] = True
    if arch == "mixtral-8x7b":
        ov["no_fsdp_experts"] = True
    if arch == "deepseek-v3-671b":
        ov["moe_full_ep"] = True
    return ov
