"""Model factory: ArchConfig -> model instance (family dispatch)."""
from __future__ import annotations

from repro_torch.models.hybrid import JambaLM
from repro_torch.models.rwkv_lm import RWKVLM
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.whisper import WhisperLM


def build_model(cfg, dist=None, long_context=False):
    """Every family of the reference: the dense and MoE decoder families
    (mistral-nemo, gemma3, minicpm, internvl2's language model, mixtral,
    DeepSeek-V3 with its MLA and multi-token prediction), RWKV6, Jamba,
    and Whisper's encoder-decoder (``cfg.is_encdec``).  ``dist``: a mesh
    context (``distribution/context.py``), on which every family serves
    and trains."""
    if cfg.rwkv is not None:
        return RWKVLM(cfg, dist)
    if cfg.mamba is not None and cfg.attn_layer_period:
        return JambaLM(cfg, dist, long_context=long_context)
    if not cfg.is_encdec:
        return DecoderLM(cfg, dist)
    return WhisperLM(cfg, dist)
