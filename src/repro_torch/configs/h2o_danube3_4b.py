"""H2O-Danube3-4B. [arXiv:2401.16818 lineage — llama+mistral mix, SWA]

24L, d_model=3840, 32 heads (GQA kv=8), head_dim=120, d_ff=10240,
vocab=32000, sliding-window attention (4096) on all layers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    max_seq=524288,               # SWA makes long contexts linear-cost
    rope_theta=500_000.0,
    sliding_window=4096,
    act="silu",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, max_seq=512, sliding_window=16)
