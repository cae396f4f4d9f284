"""RWKV-6 "Finch" 1.6B. [arXiv:2404.05892]

24L, d_model=2048 (attention-free; 32 heads of 64), channel-mix
d_ff=7168 (3.5x), vocab=65536.  Data-dependent decay via LoRA (rank 64),
5-way ddlerp token-shift mix (rank 32).
"""
from repro_torch.configs.base import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                    # d_model / rwkv.head_dim
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    max_seq=524288,                # O(1)-state decode: unbounded context
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    norm="layernorm",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, max_seq=512,
    rwkv=RWKVConfig(head_dim=16, decay_lora=8, mix_lora=4))
