"""DeepSeek-V3 (671B total / ~37B active). [arXiv:2412.19437]

61L, d_model=7168, 128 heads, vocab=129280.  Multi-head Latent Attention
(q_lora 1536, kv_lora 512, nope/rope head dims 128/64, v 128 — the KV
cache holds only the 512+64 latent per token).  MoE: 256 routed experts
top-8 + 1 shared expert, expert d_ff=2048 (assignment spec), sigmoid
router with selected-normalization.  Depth-1 multi-token prediction.

Deviation (documented in DESIGN.md): the released model keeps the first 3
layers dense (d_ff 18432); we run all 61 layers MoE so the layer stack is
homogeneous under ``lax.scan`` (param totals differ by <1%).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    max_seq=131072,
    rope_theta=10_000.0,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048,
                  n_shared_experts=1, capacity_factor=1.25,
                  aux_loss_coef=0.0001),   # V3 is aux-free; keep a trace
    mtp_depth=1,
    act="silu",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=512, max_seq=512,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared_experts=1,
                  aux_loss_coef=0.0001))
