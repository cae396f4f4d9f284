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
    context (``distribution/context.py``), on which ``DecoderLM`` serves;
    the other families raise on an active one."""
    if cfg.rwkv is not None:
        model = RWKVLM(cfg)
    elif cfg.is_encdec:
        model = WhisperLM(cfg)
    elif cfg.mamba is not None and cfg.attn_layer_period:
        model = JambaLM(cfg, long_context=long_context)
    else:
        return DecoderLM(cfg, dist)
    if dist is not None and dist.active:
        raise NotImplementedError(f"{type(model).__name__} on a mesh: "
                                  f"ROADMAP Queue 1 item 12, point 6")
    return model
