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

``RWKVLM(cfg, dist)`` serves and trains on a ("data", "model") mesh
(``distribution/context.py``) as explicit SPMD, as ``DecoderLM`` does:
each rank holds its blocks of the params (``sharding.shard_params`` by
the rule table), its rows of the batch and its H/tp heads of the WKV
state; the blocks compute on local heads (``rwkv6.py``), the embedding
and head take the vocab split over `model` (``common.py``).  The state
on a mesh: ``wkv`` (L, b/dp, H/tp, hd, hd) and ``tm_x``, ``cm_x`` (L,
b/dp, d) whole on every `model` rank (``cache_specs``).  The reference
cuts the two carries over `model`, but the token shift reads them whole
on every rank, as its input x is; holding them whole costs 2 L d entries
a row (196 KB a row at rwkv6-1.6b in bf16) and spares an all-gather of
each a layer and step.  ``loss`` gathers each FSDP leaf over `data` at
its use, a layer's inside its checkpointed layer, so the recompute and
the backward issue the same collectives in the same order on every rank
(``DecoderLM.loss``), and takes the split-vocab cross entropy of the
global batch (``common.next_token_loss``).
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.distribution import sharding as S
from repro_torch.distribution.context import NULL_CTX
from repro_torch.models import common as C
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R


class RWKVLM:
    def __init__(self, cfg, dist=None):
        self.cfg = cfg
        self.dist = dist or NULL_CTX
        self.dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                      else torch.float32)
        hd = cfg.rwkv.head_dim
        d_l = S.local_width(cfg.d_model, self.dist)
        if d_l % hd:
            raise ValueError(f"{cfg.d_model // hd} heads do not divide over "
                             f"`model` ({self.dist.tp_size})")
        self.n_local_heads = d_l // hd

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

    def layout(self):
        """(specs, full shapes) of the params, as ``DecoderLM.layout``."""
        shapes = self.init(None, "meta")
        return S.param_specs(self, shapes), shapes

    # --------------------------------------------------------------- forward

    def _layer_fn(self, x, lp, state):
        """One layer, functional: returns (x, the new state)."""
        cfg, dist = self.cfg, self.dist
        h = L.apply_norm(x, lp["ln1"], cfg)
        y, (wkv, tm_x) = R.time_mix(h, lp["tm"], cfg, state["wkv"],
                                    state["tm_x"], dist)
        x = x + y
        h = L.apply_norm(x, lp["ln2"], cfg)
        y, cm_x = R.channel_mix(h, lp["cm"], state["cm_x"], dist)
        return x + y, {"wkv": wkv, "tm_x": tm_x, "cm_x": cm_x}

    def _layer(self, x, lp, state):
        """One layer; ``state`` holds this layer's views of the state,
        overwritten with the new state."""
        x, new = self._layer_fn(x, lp, state)
        for key, value in new.items():
            state[key].copy_(value)
        return x

    def _train_layer(self, x, lp, state, fsdp=None):
        """``fsdp``: the layers' (specs, full shapes) where the layer's
        leaves are gathered over `data` first (training on a mesh)."""
        if fsdp is not None:
            lp = S.fsdp_gather(lp, *fsdp, self.dist, lead=1)
        return self._layer_fn(x, lp, state)[0]

    def _run_layers(self, x, params, cache):
        for l in range(self.cfg.n_layers):
            x = self._layer(x, C.index_layer(params["layers"], l),
                            C.index_layer(cache, l))
        return x

    def _embed(self, params, tokens):
        x = C.embed(tokens, params["embed"], self.cfg, self.dist)
        return L.apply_norm(x, params["ln0"], self.cfg)

    def loss(self, params, batch):
        """batch: tokens (b, s), labels (b, s), optional loss_mask (b, s)
        (on a mesh, this rank's rows).  Returns (xent, {"xent", "aux_loss":
        f32 0}), every layer under activation checkpointing from a zero
        state."""
        cfg, dist = self.cfg, self.dist
        fsdp = None
        if dist.active:
            specs, shapes = self.layout()
            params = {k: (v if k == "layers" else
                          S.fsdp_gather(v, specs[k], shapes[k], dist))
                      for k, v in params.items()}
            fsdp = (specs["layers"], shapes["layers"])
        x = self._embed(params, batch["tokens"])
        cache = self.init_cache(x.shape[0], 0, x.device)
        layers = C.unstack_layers(params["layers"], cfg.n_layers)
        for l, lp in enumerate(layers):
            # no layer draws random numbers: no RNG state to keep
            x = ckpt.checkpoint(self._train_layer, x, lp,
                                C.index_layer(cache, l), fsdp,
                                use_reentrant=False, preserve_rng_state=False)
        x = L.apply_norm(x, params["final_norm"], cfg)
        logits = C.lm_logits(x, params["embed"], cfg, dist, gather=False)
        xent = C.next_token_loss(logits, batch["labels"],
                                 batch.get("loss_mask"), cfg, dist)
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
        logits = C.lm_logits(x, params["embed"], self.cfg, self.dist)
        return logits, cache, tokens.shape[1]

    def decode(self, params, cache, tokens, length):
        """tokens (b, 1).  Updates ``cache`` in place and returns (logits
        (b, 1, V), cache, length + 1)."""
        x = self._embed(params, tokens)
        x = self._run_layers(x, params, cache)
        x = L.apply_norm(x, params["final_norm"], self.cfg)
        logits = C.lm_logits(x, params["embed"], self.cfg, self.dist)
        return logits, cache, length + 1

    # --------------------------------------------------------------- caches

    def cache_specs(self):
        """Specs of ``init_cache``'s layout (module docstring: the shift
        carries whole over `model`)."""
        dp = self.dist.batch_axes()
        H = self.cfg.d_model // self.cfg.rwkv.head_dim
        heads = "model" if self.n_local_heads < H else None
        return {"wkv": (None, dp, heads, None, None),
                "tm_x": (None, dp, None), "cm_x": (None, dp, None)}

    def init_cache(self, batch, max_len, device):
        """A zero state; on a mesh ``batch`` is this rank's rows, and the
        wkv state holds its heads."""
        del max_len
        cfg = self.cfg
        hd = cfg.rwkv.head_dim
        H = self.n_local_heads
        Ln = cfg.n_layers
        return {
            "wkv": torch.zeros((Ln, batch, H, hd, hd), dtype=torch.float32,
                               device=device),
            "tm_x": torch.zeros((Ln, batch, cfg.d_model), dtype=self.dtype,
                                device=device),
            "cm_x": torch.zeros((Ln, batch, cfg.d_model), dtype=self.dtype,
                                device=device),
        }
