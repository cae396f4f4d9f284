from repro_torch.configs.base import (ArchConfig, MLAConfig, MambaConfig,
                                MoEConfig, RWKVConfig, ShapeSpec, SHAPES,
                                SMOKE_SHAPES)
from repro_torch.configs.registry import (ARCH_IDS, all_cells, cell_is_lowerable,
                                    get_config, get_shape, get_smoke)

__all__ = [
    "ArchConfig", "MLAConfig", "MambaConfig", "MoEConfig", "RWKVConfig",
    "ShapeSpec", "SHAPES", "SMOKE_SHAPES", "ARCH_IDS", "all_cells",
    "cell_is_lowerable", "get_config", "get_shape", "get_smoke",
]
