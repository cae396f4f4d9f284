"""InternVL2-Llama3-76B. [arXiv:2404.16821]

LLM backbone (Hermes-2-Theta-Llama-3-70B): 80L, d_model=8192, 64 heads
(GQA kv=8), head_dim=128, d_ff=28672, vocab=128256, rope_theta=500k.
The InternViT-6B vision frontend is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings
(b, n_vision_patches, d_model) which are prepended to the token stream.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    max_seq=131072,
    rope_theta=500_000.0,
    n_vision_patches=256,
    act="silu",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, max_seq=512, n_vision_patches=8)
