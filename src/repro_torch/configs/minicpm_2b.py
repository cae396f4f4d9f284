"""MiniCPM-2B. [arXiv:2404.06395]

40L, d_model=2304, 36 heads (MHA, kv=36), head_dim=64, d_ff=5760,
vocab=122753.  muP-style scaling: emb_scale=12, residual scaled by
1.4/sqrt(L) (scale_depth), logits scaled by 256/2304 = 1/9.  Trained with
the WSD (warmup-stable-decay) schedule — wired into repro.optim.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    max_seq=4096,
    rope_theta=10_000.0,
    tie_embeddings=True,
    emb_scale=12.0,
    depth_scale=1.4,
    logit_scale=256.0 / 2304.0,
    act="silu",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=6, head_dim=12,
    d_ff=144, vocab_size=512, max_seq=512, logit_scale=0.5)
