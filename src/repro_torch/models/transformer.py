"""Decoder-only LM, dense and single-device MoE: the port of
``repro.models.transformer``.

Params keep the reference's pytree layout, with every per-layer weight
stacked on a leading (L, ...) dim and matrices oriented ``x @ W`` as
(d_in, d_out), so the weight bridge is a plain copy.  The reference's
``lax.scan`` over layers becomes a Python loop that indexes ``p[l]`` as
views.  Layer heterogeneity that only changes numbers (gemma3's per-layer
window and rope theta) rides along as per-layer Python ints and floats.

Prefill attention goes through the flash attention kernel's dispatcher;
decode attention is plain torch.  The KV cache has layout
(L, b, S, n_kv, hd) and is updated in place.  The FFN of a MoE layer is
``models/moe.py::apply_moe`` on one device (the reference's
``not dist.active`` branch); its aux loss is computed and dropped, since
nothing here trains.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import layers as L
from repro_torch.models import moe as M


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


class DecoderLM:
    """Decoder LM over a dict of stacked params; methods are pure apart
    from the in-place cache updates of ``prefill`` and ``decode``."""

    def __init__(self, cfg):
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
        self.router_mode = ("sigmoid" if cfg.moe and cfg.moe.n_experts >= 64
                            else "softmax_topk")

    # ------------------------------------------------------------------ init

    def init(self, generator, device=None):
        """Random params drawn from ``generator`` (which must live on
        ``device``; the card by default), each weight drawn straight into
        its (L, ...) stacked tensor: the peak is the model's size and one
        draw block (``layers.DRAW_BLOCK``)."""
        device = resolve_device(device)
        cfg, dt, lead = self.cfg, self.dtype, (self.cfg.n_layers,)
        layers = {
            "ln1": L.init_norm(cfg, dt, device, lead=lead),
            "ln2": L.init_norm(cfg, dt, device, lead=lead),
            "attn": A.init_attention(generator, cfg, dt, device, lead=lead),
            "ffn": (M.init_moe(generator, cfg, dt, device, lead=lead)
                    if cfg.moe is not None and cfg.layer_is_moe(0) else
                    L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, dt,
                               device, lead=lead)),
        }
        return {
            "embed": C.init_embedding(generator, cfg, self.dtype, device),
            "layers": layers,
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
        # buffer (jax.jit(decode, donate_argnums=(1,))).  Past the
        # cache's end the write lands on its last slot, as the
        # reference's dynamic_update_slice clamps it, and the mask below
        # (length + 1 > S) then admits every slot.
        write_at = min(length, k_c.shape[1] - 1)
        k_c[:, write_at] = k[:, 0]
        v_c[:, write_at] = v[:, 0]
        kk = A.repeat_kv(k_c, cfg.n_heads)
        vv = A.repeat_kv(v_c, cfg.n_heads)
        o = A.decode_attention(q, kk, vv, length + 1, window=win,
                               softcap=cfg.attn_logit_softcap)
        return o.reshape(x.shape[0], 1, -1) @ ap["wo"]

    def _moe(self, x, mp):
        return M.apply_moe(x, mp, self.cfg, router_mode=self.router_mode)[0]

    def _ffn(self, x, fp):
        if self.cfg.moe is not None:
            return self._moe(x, fp)
        return L.apply_mlp(x, fp, self.cfg.act)

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
        return x + C.mul_scalar(self._ffn(h, lp["ffn"]), self.residual_scale)

    # ------------------------------------------------------------- forwards

    def _run_layers(self, x, params, positions, cache, length, mode):
        """mode "prefill" fills ``cache`` from position 0, "decode" writes
        it at ``length``, "train" runs without a cache (cache None)."""
        win, theta = layer_scalars(self.cfg)
        for l in range(self.cfg.n_layers):
            ce = None if cache is None else {"k": cache["k"][l],
                                             "v": cache["v"][l]}
            x = self._layer(x, C.index_layer(params["layers"], l), win[l],
                            theta[l], positions, ce, length, mode)
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
