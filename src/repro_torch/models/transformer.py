"""Decoder-only LM, dense part: the port of ``repro.models.transformer``.

Params keep the reference's pytree layout, with every per-layer weight
stacked on a leading (L, ...) dim and matrices oriented ``x @ W`` as
(d_in, d_out), so the weight bridge is a plain copy.  The reference's
``lax.scan`` over layers becomes a Python loop that indexes ``p[l]`` as
views.  Layer heterogeneity that only changes numbers (gemma3's per-layer
window and rope theta) rides along as per-layer Python ints and floats.

Prefill attention goes through the flash attention kernel's dispatcher;
decode attention is plain torch.  The KV cache has layout
(L, b, S, n_kv, hd) and is updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import layers as L


def layer_scalars(cfg):
    """Per-layer (window, rope_theta) lists; window 0 means none."""
    win, theta = [], []
    for l in range(cfg.n_layers):
        w, t = 0, cfg.rope_theta
        if cfg.local_global_period:
            if cfg.layer_is_global(l):
                t = cfg.global_rope_theta or cfg.rope_theta
            else:
                w = cfg.local_window
        elif cfg.sliding_window:
            w = cfg.sliding_window
        win.append(int(w))
        theta.append(float(t))
    return win, theta


def _index(tree, l):
    return {k: _index(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


class DecoderLM:
    """Dense decoder LM over a dict of stacked params; methods are pure
    apart from the in-place cache update in ``decode``."""

    def __init__(self, cfg):
        if cfg.moe is not None:
            raise NotImplementedError("MoE: ROADMAP Queue 1 item 8")
        if cfg.mla is not None or cfg.mtp_depth:
            raise NotImplementedError("MLA/MTP: ROADMAP Queue 1 item 10")
        if cfg.sliding_window and not cfg.local_global_period:
            raise NotImplementedError(
                "static sliding-window attention path: ROADMAP Queue 1 "
                "item 4")
        self.cfg = cfg
        self.dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                      else torch.float32)
        self.residual_scale = C.residual_scale(cfg)

    # ------------------------------------------------------------------ init

    def _init_layer(self, generator, device):
        cfg, dt = self.cfg, self.dtype
        return {
            "ln1": L.init_norm(cfg, dt, device),
            "ln2": L.init_norm(cfg, dt, device),
            "attn": A.init_attention(generator, cfg, dt, device),
            "ffn": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, dt,
                              device),
        }

    def init(self, generator, device=None):
        """Random params drawn from ``generator`` (which must live on
        ``device``; the card by default).  Layers are drawn one at a time
        and copied into the stacked tensors, so the peak is one layer
        above the model's size."""
        device = resolve_device(device)
        cfg = self.cfg
        stacked = None
        for l in range(cfg.n_layers):
            layer = self._init_layer(generator, device)
            if stacked is None:
                stacked = _alloc_stacked(layer, cfg.n_layers)
            _copy_layer(stacked, layer, l)
        return {
            "embed": C.init_embedding(generator, cfg, self.dtype, device),
            "layers": stacked,
            "final_norm": L.init_norm(cfg, self.dtype, device),
        }

    # -------------------------------------------------------------- layers

    def _attention_full(self, x, ap, win, theta, positions, cache_entry):
        """Prefill (cache_entry = this layer's cache views, filled in
        place) or a cache-free forward (cache_entry None)."""
        cfg = self.cfg
        q, k, v = A.project_qkv(x, ap, cfg)
        if not cfg.no_rope:
            q = L.apply_rope(q, positions, theta)
            k = L.apply_rope(k, positions, theta)
        if cache_entry is not None:
            s = k.shape[1]
            cache_entry["k"][:, :s] = k
            cache_entry["v"][:, :s] = v
        k = A.repeat_kv(k, cfg.n_heads)
        v = A.repeat_kv(v, cfg.n_heads)
        o = flash_ops.flash_attention(q, k, v, causal=True, window=win,
                                      softcap=cfg.attn_logit_softcap)
        b, s = x.shape[:2]
        return o.reshape(b, s, -1) @ ap["wo"]

    def _attention_decode(self, x, ap, win, theta, cache_entry, length):
        cfg = self.cfg
        positions = torch.full((x.shape[0], 1), length, dtype=torch.long,
                               device=x.device)
        q, k, v = A.project_qkv(x, ap, cfg)
        if not cfg.no_rope:
            q = L.apply_rope(q, positions, theta)
            k = L.apply_rope(k, positions, theta)
        k_c, v_c = cache_entry["k"], cache_entry["v"]
        # in place: the counterpart of the reference's donated cache
        # buffer (jax.jit(decode, donate_argnums=(1,)))
        k_c[:, length] = k[:, 0]
        v_c[:, length] = v[:, 0]
        kk = A.repeat_kv(k_c, cfg.n_heads)
        vv = A.repeat_kv(v_c, cfg.n_heads)
        o = A.decode_attention(q, kk, vv, length + 1, window=win,
                               softcap=cfg.attn_logit_softcap)
        return o.reshape(x.shape[0], 1, -1) @ ap["wo"]

    def _layer(self, x, lp, win, theta, positions, cache_entry, length,
               mode):
        cfg = self.cfg
        h = L.apply_norm(x, lp["ln1"], cfg)
        if mode == "decode":
            attn = self._attention_decode(h, lp["attn"], win, theta,
                                          cache_entry, length)
        else:
            attn = self._attention_full(h, lp["attn"], win, theta,
                                        positions, cache_entry)
        x = x + C.mul_scalar(attn, self.residual_scale)
        h = L.apply_norm(x, lp["ln2"], cfg)
        return x + C.mul_scalar(L.apply_mlp(h, lp["ffn"], cfg.act),
                                self.residual_scale)

    # ------------------------------------------------------------- forwards

    def _run_layers(self, x, params, positions, cache, length, mode):
        """mode "prefill" fills ``cache`` from position 0, "decode" writes
        it at ``length``, "train" runs without a cache (cache None)."""
        win, theta = layer_scalars(self.cfg)
        for l in range(self.cfg.n_layers):
            ce = None if cache is None else {"k": cache["k"][l],
                                             "v": cache["v"][l]}
            x = self._layer(x, _index(params["layers"], l), win[l], theta[l],
                            positions, ce, length, mode)
        return x

    def loss(self, params, batch):
        raise NotImplementedError("training (loss, remat): ROADMAP Queue 1 "
                                  "item 6")

    def prefill(self, params, tokens, max_len, patch_embeds=None):
        """tokens (b, s) -> (last-position logits (b, 1, V), cache,
        length s).  The cache is allocated at max_len and filled."""
        if patch_embeds is not None:
            raise NotImplementedError("patch-embed prefix: ROADMAP Queue 1 "
                                      "item 4")
        x = C.embed(tokens, params["embed"], self.cfg)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        cache = self.init_cache(tokens.shape[0], max_len, x.device)
        x = self._run_layers(x, params, positions, cache, None, "prefill")
        x = L.apply_norm(x[:, -1:], params["final_norm"], self.cfg)
        logits = C.lm_logits(x, params["embed"], self.cfg)
        return logits, cache, tokens.shape[1]

    def decode(self, params, cache, tokens, length):
        """tokens (b, 1); ``length`` = number of valid cache entries (a
        Python int).  Writes the cache in place and returns (logits
        (b, 1, V), cache, length + 1)."""
        x = C.embed(tokens, params["embed"], self.cfg)
        x = self._run_layers(x, params, None, cache, length, "decode")
        x = L.apply_norm(x, params["final_norm"], self.cfg)
        logits = C.lm_logits(x, params["embed"], self.cfg)
        return logits, cache, length + 1

    # -------------------------------------------------------------- caches

    def init_cache(self, batch, max_len, device):
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=device),
                "v": torch.zeros(shape, dtype=self.dtype, device=device)}


def _alloc_stacked(layer, n):
    return {k: _alloc_stacked(v, n) if isinstance(v, dict)
            else v.new_empty((n, *v.shape)) for k, v in layer.items()}


def _copy_layer(stacked, layer, l):
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_layer(stacked[k], v, l)
        else:
            stacked[k][l].copy_(v)
