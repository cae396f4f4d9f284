"""Gemma-3 4B (per assignment; family of hf:google/gemma-3-*-pt).

34L, d_model=2560, 8 heads (GQA kv=4), head_dim=256, d_ff=10240 (geglu),
vocab=262144, 5:1 local:global attention interleave (every 6th layer
global), local window 1024, local rope theta 10k / global 1M, qk-norm,
tied embeddings with sqrt(d_model) input scaling, 128k context.
"""
import math

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    max_seq=131072,
    rope_theta=10_000.0,
    global_rope_theta=1_000_000.0,
    local_global_period=6,         # layers 6,12,... (1-indexed) are global
    local_window=1024,
    qk_norm=True,
    tie_embeddings=True,
    emb_scale=math.sqrt(2560.0),
    act="geglu",
)

SMOKE = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, max_seq=512, local_global_period=3,
    local_window=16, emb_scale=8.0)
