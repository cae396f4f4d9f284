"""RWKV6 LM assembly, attention-free: the port of
``repro.models.rwkv_lm``.

The per-layer state (the WKV matrix and the two token-shift carries)
plays the role the KV cache plays for transformers: it is what a hot
rFaaS executor keeps resident between invocations, and its size does not
grow with the sequence.  Params keep the reference's layout, every
per-layer weight stacked on a leading (L, ...) dim; the reference's
``lax.scan`` over layers becomes a Python loop that indexes the stacked
params and state as views.

The state keeps the reference's layout, ``{"wkv": (L, b, H, hd, hd) f32,
"tm_x", "cm_x": (L, b, d)}``, and ``prefill``/``decode`` write it in
place, layer by layer (the counterpart of the reference's donated cache
buffer): the state passed to ``decode`` is the one it returns.  Prefill
runs the WKV6 kernel's dispatcher once per layer; decode takes the plain
one-step path.

``loss`` is the reference's: next-token cross entropy from a zero state,
every layer under activation checkpointing that recomputes the whole
layer (the reference's ``jax.checkpoint`` of the scanned layer, which
takes no policy).  Its layers are functional (``_layer_fn`` returns the
new state, which the loss drops, as the reference discards the cache), so
autograd and the recompute see no in-place write.  On the card the WKV
gradient comes from K2's backward kernel.
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.models import common as C
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R


class RWKVLM:
    def __init__(self, cfg):
        self.cfg = cfg
        self.dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                      else torch.float32)

    # ------------------------------------------------------------------ init

    def init(self, generator, device=None):
        """Random params drawn from ``generator`` (which must live on
        ``device``; the card by default), each weight drawn straight into
        its (L, ...) stacked tensor."""
        device = resolve_device(device)
        cfg, dt, lead = self.cfg, self.dtype, (self.cfg.n_layers,)
        layers = {
            "ln1": L.init_norm(cfg, dt, device, lead=lead),
            "ln2": L.init_norm(cfg, dt, device, lead=lead),
            "tm": R.init_time_mix(generator, cfg, dt, device, lead=lead),
            "cm": R.init_channel_mix(generator, cfg, dt, device, lead=lead),
        }
        return {
            "embed": C.init_embedding(generator, cfg, self.dtype, device),
            "ln0": L.init_norm(cfg, self.dtype, device),
            "layers": layers,
            "final_norm": L.init_norm(cfg, self.dtype, device),
        }

    # --------------------------------------------------------------- forward

    def _layer_fn(self, x, lp, state):
        """One layer, functional: returns (x, the new state)."""
        cfg = self.cfg
        h = L.apply_norm(x, lp["ln1"], cfg)
        y, (wkv, tm_x) = R.time_mix(h, lp["tm"], cfg, state["wkv"],
                                    state["tm_x"])
        x = x + y
        h = L.apply_norm(x, lp["ln2"], cfg)
        y, cm_x = R.channel_mix(h, lp["cm"], state["cm_x"])
        return x + y, {"wkv": wkv, "tm_x": tm_x, "cm_x": cm_x}

    def _layer(self, x, lp, state):
        """One layer; ``state`` holds this layer's views of the state,
        overwritten with the new state."""
        x, new = self._layer_fn(x, lp, state)
        for key, value in new.items():
            state[key].copy_(value)
        return x

    def _train_layer(self, x, lp, state):
        return self._layer_fn(x, lp, state)[0]

    def _run_layers(self, x, params, cache):
        for l in range(self.cfg.n_layers):
            x = self._layer(x, C.index_layer(params["layers"], l),
                            C.index_layer(cache, l))
        return x

    def _embed(self, params, tokens):
        x = C.embed(tokens, params["embed"], self.cfg)
        return L.apply_norm(x, params["ln0"], self.cfg)

    def loss(self, params, batch):
        """batch: tokens (b, s), labels (b, s), optional loss_mask (b, s).
        Returns (xent, {"xent", "aux_loss": f32 0}), every layer under
        activation checkpointing from a zero state."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        cache = self.init_cache(x.shape[0], 0, x.device)
        layers = C.unstack_layers(params["layers"], cfg.n_layers)
        for l, lp in enumerate(layers):
            # no layer draws random numbers: no RNG state to keep
            x = ckpt.checkpoint(self._train_layer, x, lp,
                                C.index_layer(cache, l),
                                use_reentrant=False, preserve_rng_state=False)
        x = L.apply_norm(x, params["final_norm"], cfg)
        logits = C.lm_logits(x, params["embed"], cfg)
        xent = L.softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return xent, {"xent": xent, "aux_loss": aux}

    def prefill(self, params, tokens, max_len, patch_embeds=None):
        """tokens (b, s) -> (last-position logits (b, 1, V), state, s).
        The state has O(1) size, so ``max_len`` (and, as in the reference,
        ``patch_embeds``) is ignored."""
        del max_len, patch_embeds
        x = self._embed(params, tokens)
        cache = self.init_cache(tokens.shape[0], 0, x.device)
        x = self._run_layers(x, params, cache)
        x = L.apply_norm(x[:, -1:], params["final_norm"], self.cfg)
        logits = C.lm_logits(x, params["embed"], self.cfg)
        return logits, cache, tokens.shape[1]

    def decode(self, params, cache, tokens, length):
        """tokens (b, 1).  Updates ``cache`` in place and returns (logits
        (b, 1, V), cache, length + 1)."""
        x = self._embed(params, tokens)
        x = self._run_layers(x, params, cache)
        x = L.apply_norm(x, params["final_norm"], self.cfg)
        logits = C.lm_logits(x, params["embed"], self.cfg)
        return logits, cache, length + 1

    # --------------------------------------------------------------- caches

    def init_cache(self, batch, max_len, device):
        del max_len
        cfg = self.cfg
        hd = cfg.rwkv.head_dim
        H = cfg.d_model // hd
        Ln = cfg.n_layers
        return {
            "wkv": torch.zeros((Ln, batch, H, hd, hd), dtype=torch.float32,
                               device=device),
            "tm_x": torch.zeros((Ln, batch, cfg.d_model), dtype=self.dtype,
                                device=device),
            "cm_x": torch.zeros((Ln, batch, cfg.d_model), dtype=self.dtype,
                                device=device),
        }
