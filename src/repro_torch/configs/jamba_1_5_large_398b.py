"""Jamba-1.5-Large (398B total / 94B active). [arXiv:2403.19887 lineage]

72L hybrid: period of 8 = 1 attention layer (at in-period offset 4) + 7
Mamba layers; MoE (16 experts, top-2, expert d_ff=24576) on every 2nd
layer, dense MLP (d_ff=24576) on the rest.  d_model=8192, 64 heads
(GQA kv=8), head_dim=128, vocab=65536.  NO positional embeddings (the
Mamba layers carry position).  Mamba: d_state=16, d_conv=4, expand=2,
dt_rank=256.

Long-context note: Jamba serves 500k+ by keeping full attention only in
the 9 attention layers; our ``long_500k`` mode additionally windows those
layers (hybrid_long_window=4096) so the dry-run cell is sub-quadratic —
recorded as a hardware adaptation in DESIGN.md.
"""
from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    max_seq=524288,
    no_rope=True,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576,
                  layer_period=2, layer_offset=1,
                  capacity_factor=1.25, aux_loss_coef=0.01),
    attn_layer_period=8,
    attn_layer_offset=4,
    hybrid_long_window=4096,
    act="silu",
)

SMOKE = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, max_seq=512,
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, dt_rank=8),
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128,
                  layer_period=2, layer_offset=1),
    attn_layer_period=4, attn_layer_offset=2, hybrid_long_window=16)
