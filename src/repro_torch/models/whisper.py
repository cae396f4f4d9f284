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
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.whisper_tiny import N_AUDIO_FRAMES
from repro_torch.device import resolve_device
from repro_torch.distribution.context import NULL_CTX
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import layers as L


class WhisperLM:
    """Encoder-decoder over a dict of stacked params; methods are pure
    apart from the in-place cache writes of ``prefill`` and ``decode``."""

    def __init__(self, cfg, dist=None):
        self.cfg = cfg
        # a mesh context gives cache_specs; the forwards run on one device
        # (on a mesh: ROADMAP Queue 1 item 12, point 6)
        self.dist = dist or NULL_CTX
        self.dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                      else torch.float32)

    def _one_device(self):
        if self.dist.active:
            raise NotImplementedError(
                "WhisperLM on a mesh: ROADMAP Queue 1 item 12, point 6")

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

    # --------------------------------------------------------------- encoder

    def encode(self, params, frames):
        """frames (b, S_enc, d) -> the encoder output (b, S_enc, d)."""
        self._one_device()
        cfg = self.cfg
        pos = L.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                     frames.device)
        x = frames.to(self.dtype) + pos.to(self.dtype)
        b, s, _ = x.shape
        for lp in C.unstack_layers(params["enc"], cfg.n_enc_layers):
            z = L.apply_norm(x, lp["ln1"], cfg)
            q, k, v = A.project_qkv(z, lp["attn"], cfg)
            o = flash_ops.flash_attention(q, k, v, causal=False)
            x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
            z = L.apply_norm(x, lp["ln2"], cfg)
            x = x + L.apply_mlp(z, lp["mlp"], cfg.act)
        return L.apply_norm(x, params["enc_ln"], cfg)

    # --------------------------------------------------------------- decoder

    def _dec_layer_full(self, x, lp, enc, cache_entry):
        """A train or prefill decoder layer.  ``cache_entry``: this layer's
        cache views, written in place (self k/v from slot 0, the cross
        k/v whole), or None (training)."""
        cfg = self.cfg
        b, s, _ = x.shape
        z = L.apply_norm(x, lp["ln1"], cfg)
        q, k, v = A.project_qkv(z, lp["attn"], cfg)
        if cache_entry is not None:
            cache_entry["k"][:, :s] = k
            cache_entry["v"][:, :s] = v
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
        return x + L.apply_mlp(z, lp["mlp"], cfg.act)

    def _dec_layer_decode(self, x, lp, cache_entry, length):
        cfg = self.cfg
        b = x.shape[0]
        z = L.apply_norm(x, lp["ln1"], cfg)
        q, k, v = A.project_qkv(z, lp["attn"], cfg)
        k_c, v_c = cache_entry["k"], cache_entry["v"]
        # past the cache's end the write lands on its last slot, as the
        # reference's dynamic_update_slice clamps it, and the mask
        # (length + 1 > S) then admits every slot
        write_at = min(length, k_c.shape[1] - 1)
        k_c[:, write_at] = k[:, 0]
        v_c[:, write_at] = v[:, 0]
        o = A.decode_attention(q, k_c, v_c, length + 1)
        x = x + o.reshape(b, 1, -1) @ lp["attn"]["wo"]

        z = L.apply_norm(x, lp["ln_x"], cfg)
        q2 = (z @ lp["xattn"]["wq"]).reshape(b, 1, cfg.n_heads,
                                             cfg.resolved_head_dim)
        ck, cv = cache_entry["ck"], cache_entry["cv"]
        o2 = A.decode_attention(q2, ck, cv, ck.shape[1])
        x = x + o2.reshape(b, 1, -1) @ lp["xattn"]["wo"]

        z = L.apply_norm(x, lp["ln2"], cfg)
        return x + L.apply_mlp(z, lp["mlp"], cfg.act)

    def _embed_tokens(self, params, tokens, offset=0):
        """Token embeddings plus the sinusoids of positions offset ..
        offset + s - 1."""
        x = C.embed(tokens, params["embed"], self.cfg)
        pos = L.sinusoidal_positions(tokens.shape[1] + offset,
                                     self.cfg.d_model, x.device)[offset:]
        return x + pos.to(x.dtype)

    def _logits(self, params, x):
        x = L.apply_norm(x, params["final_norm"], self.cfg)
        return C.lm_logits(x, params["embed"], self.cfg)

    # -------------------------------------------------------------- public

    def loss(self, params, batch):
        """batch: frames (b, S_enc, d), tokens (b, s), labels (b, s),
        optional loss_mask (b, s).  Returns (xent, {"xent", "aux_loss"});
        each decoder layer under activation checkpointing."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"])
        x = self._embed_tokens(params, batch["tokens"])
        for lp in C.unstack_layers(params["dec"], cfg.n_layers):
            # no layer draws random numbers: no RNG state to keep
            x = ckpt.checkpoint(self._dec_layer_full, x, lp, enc, None,
                                use_reentrant=False,
                                preserve_rng_state=False)
        logits = self._logits(params, x)
        xent = L.softmax_xent(logits, batch["labels"],
                              batch.get("loss_mask"))
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
        self._one_device()
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
        ``s_enc`` slots (whisper-tiny's 1500 frames by default)."""
        cfg = self.cfg
        s_enc = s_enc or N_AUDIO_FRAMES
        hd, ln = cfg.resolved_head_dim, cfg.n_layers

        def zeros(slots):
            return torch.zeros((ln, batch, slots, cfg.n_kv_heads, hd),
                               dtype=self.dtype, device=device)

        return {"k": zeros(max_len + extra), "v": zeros(max_len + extra),
                "ck": zeros(s_enc), "cv": zeros(s_enc)}
