"""Whisper's encoder-decoder: the port of ``repro.models.whisper``.

The conv audio frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (b, S_enc, d_model).  Sinusoidal positions,
pre-LN layers, plain-GELU MLPs, LayerNorm, no rope, a tied head.

Params keep the reference's layout, every per-layer weight stacked on a
leading dim: ``enc`` (L_enc, ...) with {ln1, attn, ln2, mlp}, ``enc_ln``,
``dec`` (L, ...) with {ln1, attn, ln_x, xattn, ln2, mlp}, ``embed`` and
``final_norm``; the cross-attention ``xattn`` has no q/k norm scales.
The reference's ``lax.scan`` over layers becomes a Python loop over the
layers' views (``common.unstack_layers``).

Prefill runs all three attentions through the flash attention kernel's
dispatcher (K1): the encoder's over the frames without the causal mask,
the decoder's causal self-attention over the prompt, and its
cross-attention without the causal mask, q from the prompt against the
encoder output's k/v (sq != skv).  Decode is plain torch, as it is plain
jnp in the reference: self-attention over the cache's ``length + 1``
slots, cross-attention over every slot of the cross cache ``ck``/``cv``,
which prefill writes once.  The cache has layout {k, v: (L, b, max_len,
h, hd), ck, cv: (L, b, S_enc, h, hd)} and is written in place.

Kept as the reference has them (ROADMAP Queue 3, "Whisper"): decode
embeds each new token at sinusoidal position 0, not at its length; the
self cache's write lands on its last slot past ``max_len``, as
``dynamic_update_slice`` clamps it; no 448-token clamp.

``loss`` is the reference's: the encoder without remat, each decoder
layer under activation checkpointing (its ``jax.checkpoint`` of the
scanned layer, no policy), next-token cross entropy, an aux loss of 0.

``WhisperLM(cfg, dist)`` serves and trains on a ("data", "model") mesh
(``distribution/context.py``) as explicit SPMD, in the layout the
reference's rule table gives it under GSPMD (``sharding.py``): Whisper
sets no ``shard_heads``, so ``wq``/``wk``/``wv`` are cut over `data`
alone (``wo`` by its output columns) and every `model` rank runs K1 on
all the heads of its rows, the attentions replicated over `model` (their
gradients whole on every `model` rank: ``collectives.py``); the MLP's
``up`` holds the rank's columns and ``down`` the matching rows, a psum
over `model` after it (``common.row_sum``); the tied table is cut over
`model` by vocab where `model` divides it (the embedding's masked lookup
and the split-vocab head and loss of ``common.py``) and kept whole
otherwise (whisper-tiny's 51865).  ``frames`` and ``tokens`` are this
rank's rows (`data`).  The self cache's slots are cut over
``dist.kv_seq`` (``attention.SlotCache``): prefill writes the rank's
block, decode writes slot ``length`` on the rank that holds it and
attends over the slots gathered whole (the reference has no
sequence-parallel decode for Whisper); the cross caches ``ck``/``cv``
are whole on every `model` rank of a `data` shard (``cache_specs``).
``loss`` gathers each FSDP leaf over `data` at its use: the embedding
and norms once, an encoder layer's leaves before it, a decoder layer's
inside its checkpointed layer (``DecoderLM.loss``).
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.whisper_tiny import N_AUDIO_FRAMES
from repro_torch.device import resolve_device
from repro_torch.distribution import sharding as S
from repro_torch.distribution.context import NULL_CTX
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import layers as L


class WhisperLM(A.SlotCache):
    """Encoder-decoder over a dict of stacked params; methods are pure
    apart from the in-place cache writes of ``prefill`` and ``decode``."""

    def __init__(self, cfg, dist=None):
        self.cfg = cfg
        self.dist = dist or NULL_CTX
        self.dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                      else torch.float32)

    # ------------------------------------------------------------------ init

    def init(self, generator, device=None):
        """Random params drawn from ``generator`` (which must live on
        ``device``; the card by default), each weight drawn straight into
        its stacked tensor."""
        device = resolve_device(device)
        cfg, dt = self.cfg, self.dtype

        def layer(n, cross):
            lead = (n,)
            p = {"ln1": L.init_norm(cfg, dt, device, lead=lead),
                 "attn": A.init_attention(generator, cfg, dt, device,
                                          lead=lead)}
            if cross:
                p["ln_x"] = L.init_norm(cfg, dt, device, lead=lead)
                p["xattn"] = A.init_attention(generator, cfg, dt, device,
                                              lead=lead, cross=True)
            p["ln2"] = L.init_norm(cfg, dt, device, lead=lead)
            p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                                  dt, device, lead=lead)
            return p

        return {
            "embed": C.init_embedding(generator, cfg, dt, device),
            "enc": layer(cfg.n_enc_layers, cross=False),
            "enc_ln": L.init_norm(cfg, dt, device),
            "dec": layer(cfg.n_layers, cross=True),
            "final_norm": L.init_norm(cfg, dt, device),
        }

    def layout(self):
        """(specs, full shapes) of the params, as ``DecoderLM.layout``."""
        shapes = self.init(None, "meta")
        return S.param_specs(self, shapes), shapes

    # --------------------------------------------------------------- encoder

    def encode(self, params, frames, fsdp=None):
        """frames (b, S_enc, d) -> the encoder output (b, S_enc, d).
        ``fsdp``: the encoder layers' (specs, full shapes) where each
        layer's leaves are gathered over `data` first (training on a
        mesh)."""
        cfg = self.cfg
        pos = L.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                     frames.device)
        x = frames.to(self.dtype) + pos.to(self.dtype)
        b, s, _ = x.shape
        for lp in C.unstack_layers(params["enc"], cfg.n_enc_layers):
            if fsdp is not None:
                lp = S.fsdp_gather(lp, *fsdp, self.dist, lead=1)
            z = L.apply_norm(x, lp["ln1"], cfg)
            q, k, v = A.project_qkv(z, lp["attn"], cfg)
            o = flash_ops.flash_attention(q, k, v, causal=False)
            x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
            z = L.apply_norm(x, lp["ln2"], cfg)
            x = x + C.mlp(z, lp["mlp"], cfg, self.dist)
        return L.apply_norm(x, params["enc_ln"], cfg)

    # --------------------------------------------------------------- decoder

    def _dec_layer_full(self, x, lp, enc, cache_entry, fsdp=None):
        """A train or prefill decoder layer.  ``cache_entry``: this layer's
        cache views, written in place (self k/v from slot 0, this rank's
        block of them on a mesh; the cross k/v whole), or None
        (training).  ``fsdp``: as ``encode``'s, for the decoder layers."""
        cfg = self.cfg
        if fsdp is not None:
            lp = S.fsdp_gather(lp, *fsdp, self.dist, lead=1)
        b, s, _ = x.shape
        z = L.apply_norm(x, lp["ln1"], cfg)
        q, k, v = A.project_qkv(z, lp["attn"], cfg)
        if cache_entry is not None:
            self._write_prefill(cache_entry, {"k": k, "v": v})
        o = flash_ops.flash_attention(q, k, v, causal=True)
        x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]

        z = L.apply_norm(x, lp["ln_x"], cfg)
        q2, k2, v2 = A.project_qkv(z, lp["xattn"], cfg, kv_x=enc)
        if cache_entry is not None:
            cache_entry["ck"][:, :k2.shape[1]] = k2
            cache_entry["cv"][:, :v2.shape[1]] = v2
        o2 = flash_ops.flash_attention(q2, k2, v2, causal=False)
        x = x + o2.reshape(b, s, -1) @ lp["xattn"]["wo"]

        z = L.apply_norm(x, lp["ln2"], cfg)
        return x + C.mlp(z, lp["mlp"], cfg, self.dist)

    def _dec_layer_decode(self, x, lp, cache_entry, length):
        cfg = self.cfg
        b = x.shape[0]
        z = L.apply_norm(x, lp["ln1"], cfg)
        q, k, v = A.project_qkv(z, lp["attn"], cfg)
        k_c, v_c = cache_entry["k"], cache_entry["v"]
        # past the cache's end the write lands on its last slot, as the
        # reference's dynamic_update_slice clamps it, and the mask
        # (length + 1 > S) then admits every slot; on a mesh the rank
        # that holds the slot writes it, and every rank attends over the
        # slots gathered whole
        S_all = k_c.shape[1] * self._kv_shards()
        self._write_slot(cache_entry, {"k": k, "v": v},
                         min(length, S_all - 1))
        o = A.decode_attention(q, self._whole_cache(k_c),
                               self._whole_cache(v_c), length + 1)
        x = x + o.reshape(b, 1, -1) @ lp["attn"]["wo"]

        z = L.apply_norm(x, lp["ln_x"], cfg)
        q2 = (z @ lp["xattn"]["wq"]).reshape(b, 1, cfg.n_heads,
                                             cfg.resolved_head_dim)
        ck, cv = cache_entry["ck"], cache_entry["cv"]
        o2 = A.decode_attention(q2, ck, cv, ck.shape[1])
        x = x + o2.reshape(b, 1, -1) @ lp["xattn"]["wo"]

        z = L.apply_norm(x, lp["ln2"], cfg)
        return x + C.mlp(z, lp["mlp"], cfg, self.dist)

    def _embed_tokens(self, params, tokens, offset=0):
        """Token embeddings plus the sinusoids of positions offset ..
        offset + s - 1."""
        x = C.embed(tokens, params["embed"], self.cfg, self.dist)
        pos = L.sinusoidal_positions(tokens.shape[1] + offset,
                                     self.cfg.d_model, x.device)[offset:]
        return x + pos.to(x.dtype)

    def _logits(self, params, x, gather=True):
        """The tied head's logits; on a mesh whose rule split the vocab
        over `model`, this rank's columns unless ``gather``."""
        x = L.apply_norm(x, params["final_norm"], self.cfg)
        return C.lm_logits(x, params["embed"], self.cfg, self.dist,
                           gather=gather)

    # -------------------------------------------------------------- public

    def loss(self, params, batch):
        """batch: frames (b, S_enc, d), tokens (b, s), labels (b, s),
        optional loss_mask (b, s) (on a mesh, this rank's rows).  Returns
        (xent, {"xent", "aux_loss"}); each decoder layer under activation
        checkpointing, on a mesh the global batch's mean
        (``common.next_token_loss``)."""
        cfg, dist = self.cfg, self.dist
        fsdp_enc = fsdp_dec = None
        if dist.active:
            specs, shapes = self.layout()
            params = {k: (v if k in ("enc", "dec") else
                          S.fsdp_gather(v, specs[k], shapes[k], dist))
                      for k, v in params.items()}
            fsdp_enc = (specs["enc"], shapes["enc"])
            fsdp_dec = (specs["dec"], shapes["dec"])
        enc = self.encode(params, batch["frames"], fsdp_enc)
        x = self._embed_tokens(params, batch["tokens"])
        for lp in C.unstack_layers(params["dec"], cfg.n_layers):
            # no layer draws random numbers: no RNG state to keep
            x = ckpt.checkpoint(self._dec_layer_full, x, lp, enc, None,
                                fsdp_dec, use_reentrant=False,
                                preserve_rng_state=False)
        logits = self._logits(params, x, gather=False)
        xent = C.next_token_loss(logits, batch["labels"],
                                 batch.get("loss_mask"), cfg, dist)
        aux = torch.zeros((), dtype=torch.float32, device=xent.device)
        return xent, {"xent": xent, "aux_loss": aux}

    def prefill(self, params, tokens, max_len, frames=None,
                patch_embeds=None):
        """tokens (b, s) and frames (b, S_enc, d) (or, in their place,
        ``patch_embeds``, as the reference takes them) -> (last-position
        logits (b, 1, V), cache, length s).  The self cache has max_len
        slots, the cross cache S_enc."""
        frames = frames if frames is not None else patch_embeds
        if frames is None:
            raise ValueError("WhisperLM.prefill needs frames (b, S_enc, "
                             "d_model), or patch_embeds in their place")
        cfg = self.cfg
        enc = self.encode(params, frames)
        x = self._embed_tokens(params, tokens)
        cache = self.init_cache(tokens.shape[0], max_len, x.device,
                                s_enc=enc.shape[1])
        for l, lp in enumerate(C.unstack_layers(params["dec"],
                                                cfg.n_layers)):
            x = self._dec_layer_full(x, lp, enc, C.index_layer(cache, l))
        return self._logits(params, x[:, -1:]), cache, tokens.shape[1]

    def decode(self, params, cache, tokens, length):
        """tokens (b, 1); ``length`` = number of valid self-cache entries
        (a Python int).  Embeds the token at position 0, as the reference
        does; writes the cache in place and returns (logits (b, 1, V),
        cache, length + 1)."""
        x = self._embed_tokens(params, tokens)
        for l, lp in enumerate(C.unstack_layers(params["dec"],
                                                self.cfg.n_layers)):
            x = self._dec_layer_decode(x, lp, C.index_layer(cache, l),
                                       length)
        return self._logits(params, x), cache, length + 1

    # -------------------------------------------------------------- caches

    def cache_specs(self):
        """Specs matching ``init_cache``'s layout: the self cache's slots
        over ``dist.kv_seq``, the cross cache's whole."""
        dp = self.dist.batch_axes()
        kv = self.dist.kv_axes()
        return {"k": (None, dp, kv, None, None),
                "v": (None, dp, kv, None, None),
                "ck": (None, dp, None, None, None),
                "cv": (None, dp, None, None, None)}

    def init_cache(self, batch, max_len, device, s_enc=None, extra=0):
        """Zero caches: self k/v of max_len + extra slots, cross ck/cv of
        ``s_enc`` slots (whisper-tiny's 1500 frames by default).  On a
        mesh, this rank's block: ``batch`` is its rows, and it holds its
        share of the self cache's slots, which must divide over
        ``dist.kv_seq``."""
        cfg = self.cfg
        s_enc = s_enc or N_AUDIO_FRAMES
        hd, ln = cfg.resolved_head_dim, cfg.n_layers
        S_self, n = max_len + extra, self._kv_shards()
        if S_self % n:
            raise ValueError(f"{S_self} cache slots do not divide over "
                             f"{self.dist.kv_seq} ({n} ranks)")

        def zeros(slots):
            return torch.zeros((ln, batch, slots, cfg.n_kv_heads, hd),
                               dtype=self.dtype, device=device)

        return {"k": zeros(S_self // n), "v": zeros(S_self // n),
                "ck": zeros(s_enc), "cv": zeros(s_enc)}
