"""Architecture + shape configuration system.

Every assigned architecture is described by one :class:`ArchConfig` (exact
published hyper-parameters) plus a reduced ``smoke`` variant of the same
family used by CPU tests.  Shapes are global (seq_len, batch) cells from the
assignment; ``kind`` decides whether the dry-run lowers ``train_step``,
``prefill_step`` or ``decode_step``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0              # hidden dim of each expert MLP
    n_shared_experts: int = 0      # DeepSeek-style always-on experts
    layer_period: int = 1          # MoE FFN every `period` layers
    layer_offset: int = 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> d_model // 16


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    max_seq: int = 131072

    # --- attention flavour ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 = full attention everywhere
    local_global_period: int = 0   # gemma3: every Nth layer is global
    local_window: int = 0          # window used by the local layers
    global_rope_theta: float = 0.0 # gemma3 global layers use 1M theta
    attn_logit_softcap: float = 0.0
    qk_norm: bool = False
    no_rope: bool = False          # jamba: no positional embedding at all

    # --- residual / embedding scaling (MiniCPM muP-ish, Gemma) ---
    emb_scale: float = 1.0
    depth_scale: float = 0.0       # residual scaled by depth_scale/sqrt(L)
    logit_scale: float = 1.0
    tie_embeddings: bool = False

    # --- families ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # hybrid (jamba): one attention layer per `attn_layer_period` layers
    attn_layer_period: int = 0
    attn_layer_offset: int = 0
    hybrid_long_window: int = 0    # window for attn layers on long_* shapes

    # enc-dec (whisper)
    is_encdec: bool = False
    n_enc_layers: int = 0

    # vlm (internvl2): stub frontend prepends this many patch embeddings
    n_vision_patches: int = 0

    # multi-token prediction (DeepSeek-V3)
    mtp_depth: int = 0

    norm_eps: float = 1e-5
    act: str = "silu"
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    dtype: str = "bfloat16"

    # ---------- derived ----------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.rwkv is not None

    @property
    def subquadratic(self) -> bool:
        """True if the arch can lower the long_500k cell (no full-attention
        layer whose cost is quadratic in seq)."""
        if self.rwkv is not None:
            return True
        if self.mamba is not None and self.attn_layer_period:
            # hybrid: OK if attn layers run windowed in long-context mode
            return self.hybrid_long_window > 0
        if self.is_encdec or self.n_vision_patches:
            return False
        if self.local_global_period:
            return False           # global layers remain quadratic
        return self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True                # all assigned archs autoregress

    def layer_is_global(self, layer: int) -> bool:
        if not self.local_global_period:
            return self.sliding_window == 0
        return (layer + 1) % self.local_global_period == 0

    def layer_is_attention(self, layer: int) -> bool:
        """Hybrid archs: which mixer a layer uses."""
        if not self.attn_layer_period:
            return self.mamba is None and self.rwkv is None
        return layer % self.attn_layer_period == self.attn_layer_offset

    def layer_is_moe(self, layer: int) -> bool:
        if self.moe is None:
            return False
        return layer % self.moe.layer_period == self.moe.layer_offset

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---------- parameter counting (analytic, for roofline) ----------
    def param_counts(self) -> dict:
        """Returns {'total': N, 'active': N_active} (active counts top-k
        experts only — used for MODEL_FLOPS = 6*N_active*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * nq * qk_hd
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                p += nq * m.v_head_dim * d
                return p
            return d * hd * (nq + 2 * nkv) + nq * hd * d

        def mlp_params(ff: int) -> int:
            n_mats = 3 if self.act in ("silu", "geglu") else 2
            return n_mats * d * ff

        def rwkv_params() -> int:
            r = self.rwkv
            # r,k,v,g,w,o projections + loras + channel mix
            p = 5 * d * d + d * d                       # time-mix mats + out
            p += 5 * (d * r.mix_lora + r.mix_lora * d)  # ddlerp loras
            p += d * r.decay_lora + r.decay_lora * d    # decay lora
            p += d * self.d_ff + self.d_ff * d + d * d  # channel mix k,v,r
            return p

        def mamba_params() -> int:
            m = self.mamba
            di = m.expand * d
            dtr = m.dt_rank or d // 16
            p = d * 2 * di                  # in_proj (x, z)
            p += di * m.d_conv              # conv
            p += di * (dtr + 2 * m.d_state) # x_proj
            p += dtr * di + di              # dt_proj
            p += di * m.d_state + di        # A_log, D
            p += di * d                     # out_proj
            return p

        total = active = 0
        n_dec = self.n_layers
        for l in range(n_dec):
            if self.layer_is_attention(l):
                total += attn_params(); active += attn_params()
            elif self.rwkv is not None:
                total += rwkv_params(); active += rwkv_params()
            else:
                total += mamba_params(); active += mamba_params()
            if self.layer_is_moe(l):
                m = self.moe
                e = mlp_params(m.d_expert)
                total += m.n_experts * e + m.n_shared_experts * e
                total += d * m.n_experts            # router
                active += (m.top_k + m.n_shared_experts) * e
            else:
                total += mlp_params(self.d_ff); active += mlp_params(self.d_ff)
        if self.is_encdec:
            for _ in range(self.n_enc_layers):
                total += attn_params() + mlp_params(self.d_ff)
                active += attn_params() + mlp_params(self.d_ff)
            # decoder cross attention
            total += n_dec * attn_params(); active += n_dec * attn_params()
        total += emb; active += emb
        return {"total": int(total), "active": int(active)}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Reduced shapes used by smoke tests on CPU.
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 32, 2, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 64, 1, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 64, 2, "decode"),
    "long_500k": ShapeSpec("long_500k", 128, 1, "decode"),
}
