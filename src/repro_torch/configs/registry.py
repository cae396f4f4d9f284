"""Central registry mapping arch ids to their exact + smoke configs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, SMOKE_SHAPES, ArchConfig, ShapeSpec

_MODULES = {
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return importlib.import_module(_MODULES[arch_id]).SMOKE


def get_shape(name: str, smoke: bool = False) -> ShapeSpec:
    return (SMOKE_SHAPES if smoke else SHAPES)[name]


def cell_is_lowerable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """Whether an (arch x shape) dry-run cell applies (DESIGN.md §7)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


def all_cells(include_skipped: bool = False):
    """Yields (arch_id, shape_name, lowerable)."""
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            ok = cell_is_lowerable(cfg, SHAPES[s])
            if ok or include_skipped:
                yield a, s, ok
