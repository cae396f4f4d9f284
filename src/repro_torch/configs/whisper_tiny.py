"""Whisper-tiny. [arXiv:2212.04356]

Encoder-decoder, 4+4L, d_model=384, 6 heads (MHA), d_ff=1536 (plain GELU
MLP), vocab=51865, LayerNorm, sinusoidal positions.  The conv audio
frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (b, n_frames, d_model).
"""
from repro_torch.configs.base import ArchConfig

N_AUDIO_FRAMES = 1500              # 30 s of audio after the conv frontend

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,                    # decoder layers
    n_enc_layers=4,
    is_encdec=True,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    max_seq=4096,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, max_seq=512)
