"""Model factory: ArchConfig -> model instance (family dispatch)."""
from __future__ import annotations

from repro_torch.models.transformer import DecoderLM


def build_model(cfg):
    """The dense decoder families (mistral-nemo, gemma3, minicpm,
    internvl2's language model) are ported; the others raise."""
    if cfg.rwkv is not None:
        raise NotImplementedError("RWKV6: ROADMAP Queue 1 item 7")
    if cfg.is_encdec:
        raise NotImplementedError("Whisper: ROADMAP Queue 1 item 11")
    if cfg.mamba is not None:
        raise NotImplementedError("Mamba/Jamba: ROADMAP Queue 1 item 9")
    return DecoderLM(cfg)
