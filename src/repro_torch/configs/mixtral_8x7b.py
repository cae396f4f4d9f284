"""Mixtral-8x7B. [arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1]

32L, d_model=4096, 32 heads (GQA kv=8), head_dim=128, vocab=32000,
MoE: 8 experts, top-2, expert d_ff=14336, softmax-over-top-k router.
Sliding-window attention (4096) per the original Mistral-7B recipe.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    max_seq=524288,               # SWA -> linear long-context cost
    rope_theta=1_000_000.0,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336,
                  capacity_factor=1.25, aux_loss_coef=0.01),
    act="silu",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, max_seq=512, sliding_window=16,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=64))
