"""Mistral-Nemo-Base-2407 (12B). [hf:mistralai/Mistral-Nemo-Base-2407]

40L, d_model=5120, 32 heads (GQA kv=8), head_dim=128 (explicit — NOT
d_model/n_heads), d_ff=14336, vocab=131072 (Tekken), 128k context,
rope_theta=1e6, full attention.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    max_seq=131072,
    rope_theta=1_000_000.0,
    act="silu",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, max_seq=512)
