"""Decoder-only LM, dense, single-device MoE and MLA: the port of
``repro.models.transformer``.

Params keep the reference's pytree layout, with every per-layer weight
stacked on a leading (L, ...) dim and matrices oriented ``x @ W`` as
(d_in, d_out), so the weight bridge is a plain copy.  The reference's
``lax.scan`` over layers becomes a Python loop that indexes ``p[l]`` as
views.  Layer heterogeneity that only changes numbers (gemma3's per-layer
window and rope theta) rides along as per-layer Python ints and floats.

Prefill attention goes through the flash attention kernel's dispatcher,
a static sliding window (mixtral, h2o-danube) included: K1's window mask
is that of the reference's ``sliding_window_attention``.  Decode
attention is plain torch.  The KV cache has layout (L, b, S, n_kv, hd)
and is updated in place; with ``window_cache`` on, decode uses it as the
reference's ring buffer.  A vision prefix (internvl2's patch embeddings)
goes in front of the prompt's token embeddings.  With ``cfg.mla``
(DeepSeek-V3) the attention is ``attention.py``'s MLA: prefill through
K1 at the q·k head dim, decode absorbed against a latent cache of layout
{ckv: (L, b, S, kv_lora_rank), krope: (L, b, S, rope dim)}.  The FFN of
a MoE layer is ``models/moe.py::apply_moe``, and its aux loss joins the
training loss.

``DecoderLM(cfg, dist)`` serves on a mesh (``distribution/context.py``)
as explicit SPMD: each rank holds its shard of every parameter
(``sharding.shard_params`` by the rule table), its rows of the batch
(`data`) and its slots of the cache (the sequence dim over
``dist.kv_seq``), and writes out the collectives the reference's GSPMD
inserts: the embedding's masked lookup and the logits' all-gather over a
vocab split on `model` (``common.py``); attention on this rank's q heads
(``shard_heads``: wq by columns, wo by rows, then a psum over `model`;
MLA's heads through its up-projections' columns), the kv heads of those
q heads, prefill through K1; the dense MLP's row-split ``down`` summed
over `model`; the MoE's expert-, tensor- or full expert-parallel mode of
the reference's ``_moe``.  Decode writes each new slot on the rank that
holds it; with ``sp_decode`` it attends each rank's slots and combines by
log-sum-exp (``decode_attention_sp``, ``mla_decode_sp``), without it the
ranks all-gather the cache and run the one-device decode on their heads,
the function GSPMD computes.  The serving knobs are the reference's
attributes (``sp_decode``, ``window_cache``, ``moe_full_ep``,
``no_fsdp_experts``; ``launch/specs.py::optimized_overrides``).

``loss`` trains on a mesh with the same explicit SPMD, its gradient
carried across ranks by the collectives' backwards (``collectives.py``):
``batch`` holds this rank's rows (`data`), and the loss is the global
batch's mean (``common.next_token_loss``: the vocab stays split over
`model`).  Params cut by ``sharding.shard_params(..., train=True)`` hold
FSDP blocks over `data` too; each is gathered whole over `data` at its
use (``sharding.fsdp_gather``: the embedding and head once, a layer's
leaves inside its checkpointed layer, so the recompute gathers again),
and the gather's backward leaves each rank its block's summed gradient.
A leaf no `data` dim cuts ends with this rank's rows' part of its
gradient, which the train step sums (``training/step.py``).  A MoE
layer's capacity and aux loss are each `data` shard's, the aux averaged
over `data`, as the reference's shard_map computes them
(``src/repro/models/transformer.py:147-200``); full expert parallelism,
a decode layout, raises.

``loss`` is the reference's: next-token cross entropy plus the MoE aux
loss, each layer under activation checkpointing (the reference's
``jax.checkpoint`` of the scanned layer; ``remat_policy`` None recomputes
the whole layer in the backward, "dots" keeps the outputs of its matrix
products).  With ``cfg.mtp_depth`` it adds the reference's depth-1
multi-token prediction loss (``_mtp_loss``) at weight 0.3.  Its
attention gradient comes from K1's backward kernel on the card.  Params
stay stacked: each step takes every layer's views with one
``unbind`` per leaf, so the gradients land in the stacked leaves (the
stacked norm scales are matrices to AdamW's decay, as in the reference).
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.distribution import sharding as S
from repro_torch.distribution.context import NULL_CTX
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


class DecoderLM(A.SlotCache):
    """Decoder LM over a dict of stacked params; methods are pure apart
    from the in-place cache updates of ``prefill`` and ``decode``."""

    STACK = "layers"          # the params' key of the stacked layers

    def __init__(self, cfg, dist=None):
        self.cfg = cfg
        self.dist = dist or NULL_CTX
        self.dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                      else torch.float32)
        self.residual_scale = C.residual_scale(cfg)
        tp = self.dist.tp_size
        self.shard_heads = (cfg.mla is None and cfg.n_heads % tp == 0
                            and (cfg.n_heads * cfg.resolved_head_dim) % tp
                            == 0)
        self.router_mode = ("sigmoid" if cfg.moe and cfg.moe.n_experts >= 64
                            else "softmax_topk")
        # uniform static window (every layer's, from layer_scalars)
        self.static_window = (cfg.sliding_window if cfg.sliding_window and
                              not cfg.local_global_period else 0)
        self.moe_ep = bool(cfg.moe and self.dist.active
                           and cfg.moe.n_experts % tp == 0
                           and cfg.moe.n_experts >= tp)
        # serving knobs (launch/specs.py::optimized_overrides)
        self.sp_decode = False        # sequence-parallel decode on a mesh
        # the reference's ring-buffer KV cache for sliding-window decode:
        # right only for a cache of exactly the window's slots and a
        # prompt no longer than that
        self.window_cache = False
        self.moe_full_ep = False      # experts over (data x model)
        self.no_fsdp_experts = False  # serving: experts whole on `data`
        self.remat_policy = None      # None | "dots" (checkpoint policy)

    def full_ep_available(self):
        cfg, dist = self.cfg, self.dist
        if cfg.moe is None or not dist.active:
            return False
        n = dist.axis_size("data") * dist.axis_size("model")
        return cfg.moe.n_experts % n == 0 and cfg.moe.n_experts >= n

    # ------------------------------------------------------------------ init

    def init(self, generator, device=None):
        """Random params drawn from ``generator`` (which must live on
        ``device``; the card by default), each weight drawn straight into
        its (L, ...) stacked tensor: the peak is the model's size and one
        draw block (``layers.DRAW_BLOCK``)."""
        device = resolve_device(device)
        cfg, dt = self.cfg, self.dtype
        layers = self._init_layer(generator, device, lead=(cfg.n_layers,))
        params = {
            "embed": C.init_embedding(generator, cfg, dt, device),
            "layers": layers,
            "final_norm": L.init_norm(cfg, dt, device),
        }
        if cfg.mtp_depth:
            params["mtp"] = {
                "proj": L.dense_init(generator, (2 * cfg.d_model,
                                                 cfg.d_model), dt, device),
                "layer": self._init_layer(generator, device),
                "norm": L.init_norm(cfg, dt, device),
            }
        return params

    def _init_layer(self, generator, device, lead=()):
        """One layer's params, stacked on ``lead``."""
        cfg, dt = self.cfg, self.dtype
        attn = A.init_mla if cfg.mla is not None else A.init_attention
        return {
            "ln1": L.init_norm(cfg, dt, device, lead=lead),
            "ln2": L.init_norm(cfg, dt, device, lead=lead),
            "attn": attn(generator, cfg, dt, device, lead=lead),
            "ffn": (M.init_moe(generator, cfg, dt, device, lead=lead)
                    if cfg.moe is not None and cfg.layer_is_moe(0) else
                    L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, dt,
                               device, lead=lead)),
        }

    # ------------------------------------------------------- shardings (MoE)

    def moe_param_specs(self, stacked: bool):
        """The expert weights' specs as ``_moe``'s local blocks take them
        (the reference's shard_map in_specs); the rule table cuts the
        same blocks (FSDP entries aside)."""
        pre = (None,) if stacked else ()
        if self.moe_full_ep and self.full_ep_available():
            ed = ("data", "model")
            w = {"router": (*pre, None, None), "gate": (*pre, ed, None, None),
                 "up": (*pre, ed, None, None), "down": (*pre, ed, None, None)}
        elif self.moe_ep:
            w = {"router": (*pre, None, None),
                 "gate": (*pre, "model", None, None),
                 "up": (*pre, "model", None, None),
                 "down": (*pre, "model", None, None)}
        else:
            w = {"router": (*pre, None, None),
                 "gate": (*pre, None, None, "model"),
                 "up": (*pre, None, None, "model"),
                 "down": (*pre, None, "model", None)}
        if self.cfg.moe and self.cfg.moe.n_shared_experts:
            w["shared"] = {"gate": (*pre, None, "model"),
                           "up": (*pre, None, "model"),
                           "down": (*pre, "model", None)}
        return w

    def layout(self):
        """(specs, full shapes) of the params: ``sharding.param_specs`` of
        the whole model (drawn on the meta device: shapes only) under the
        knobs set now.  Training on a mesh reads both to gather a leaf's
        FSDP blocks."""
        shapes = self.init(None, "meta")
        return S.param_specs(self, shapes), shapes

    # -------------------------------------------------------------- layers

    def _attention_full(self, x, ap, win, theta, positions, cache_entry):
        """Prefill (cache_entry = this layer's cache views, filled in
        place) or a cache-free forward (cache_entry None), on this rank's
        q heads.  MLA takes ``cfg.rope_theta`` and no window, as in the
        reference."""
        cfg, dist = self.cfg, self.dist
        if cfg.mla is not None:
            out, c_kv, k_rope = A.mla_prefill(x, ap, cfg, positions, dist)
            if cache_entry is not None:
                self._write_prefill(cache_entry, {"ckv": c_kv,
                                                  "krope": k_rope})
            return out
        q, k, v = A.project_qkv(x, ap, cfg, dist=dist)
        if not cfg.no_rope:
            q = L.apply_rope(q, positions, theta)
            k = L.apply_rope(k, positions, theta)
        if cache_entry is not None:
            self._write_prefill(cache_entry, {"k": k, "v": v})
        h = q.shape[2]
        k = A.local_kv(k, cfg.n_heads, h, dist)
        v = A.local_kv(v, cfg.n_heads, h, dist)
        o = flash_ops.flash_attention(q, k, v, causal=True, window=win,
                                      softcap=cfg.attn_logit_softcap)
        b, s = x.shape[:2]
        return A.out_proj(o.reshape(b, s, -1), ap["wo"], h, cfg.n_heads,
                          dist)

    def _attention_decode(self, x, ap, win, theta, cache_entry, length):
        cfg, dist = self.cfg, self.dist
        sp = self.sp_decode and dist.active
        positions = torch.full((x.shape[0], 1), length, dtype=torch.long,
                               device=x.device)
        if cfg.mla is not None:
            c_kv, k_rope = A.mla_latents(x, ap, cfg, positions, dist)
            S = cache_entry["ckv"].shape[1] * self._kv_shards()
            # clamped to the last slot past the cache's end, as below
            self._write_slot(cache_entry, {"ckv": c_kv, "krope": k_rope},
                             min(length, S - 1))
            ckv_c, krope_c = cache_entry["ckv"], cache_entry["krope"]
            if sp:
                return A.mla_decode_sp(x, ap, cfg, ckv_c, krope_c,
                                       length + 1, positions, dist)
            return A.mla_decode(x, ap, cfg, self._whole_cache(ckv_c),
                                self._whole_cache(krope_c), length + 1,
                                positions, dist)
        q, k, v = A.project_qkv(x, ap, cfg, dist=dist)
        if not cfg.no_rope:
            q = L.apply_rope(q, positions, theta)
            k = L.apply_rope(k, positions, theta)
        S = cache_entry["k"].shape[1] * self._kv_shards()
        if self.window_cache:
            # ring buffer: slot length % S; keys are stored rotated, so
            # attention over the slots needs no order and no window mask
            write_at, n_valid, win = length % S, min(length + 1, S), 0
        else:
            # Past the cache's end the write lands on its last slot, as
            # the reference's dynamic_update_slice clamps it, and the
            # mask (length + 1 > S) then admits every slot.
            write_at, n_valid = min(length, S - 1), length + 1
        # in place: the counterpart of the reference's donated cache
        # buffer (jax.jit(decode, donate_argnums=(1,)))
        self._write_slot(cache_entry, {"k": k, "v": v}, write_at)
        k_c, v_c = cache_entry["k"], cache_entry["v"]
        h = q.shape[2]
        h0 = A.head_offset(h, cfg.n_heads, dist)
        if sp:
            if h < cfg.n_heads:       # every head attends this rank's slots
                q = dist.comm.all_gather(q, dist.tp, dim=2)
            o = A.decode_attention_sp(q, k_c, v_c, n_valid, dist,
                                      window=win,
                                      softcap=cfg.attn_logit_softcap
                                      )[:, :, h0:h0 + h]
        else:
            kk = A.repeat_kv(self._whole_cache(k_c), cfg.n_heads, h0, h)
            vv = A.repeat_kv(self._whole_cache(v_c), cfg.n_heads, h0, h)
            o = A.decode_attention(q, kk, vv, n_valid, window=win,
                                   softcap=cfg.attn_logit_softcap)
        return A.out_proj(o.reshape(x.shape[0], 1, -1), ap["wo"], h,
                          cfg.n_heads, dist)

    def _moe(self, x, mp):
        """(y, aux loss): one device, or the reference's mesh branch.  The
        reference's pmean of aux over every axis is taken over the batch
        axes: every `model` rank routes the same tokens, so its mean over
        `model` is the value itself (and a mean there would divide the
        gradient that ``collectives.py``'s convention gives each rank
        whole)."""
        cfg, dist = self.cfg, self.dist
        if not dist.active:
            return M.apply_moe(x, mp, cfg, router_mode=self.router_mode)
        comm = dist.comm
        all_axes = tuple(a for a in ("pod", "data", "model")
                         if a in dist.axis_names)
        if self.moe_full_ep and self.full_ep_available():
            # Full EP: a few experts a rank, weights never move; tokens
            # all-gather over `data`, outputs psum back in the model dtype
            # and each rank keeps its batch rows.
            has_data = "data" in dist.axis_names
            n_local = mp["gate"].shape[0]
            xg = comm.all_gather(x, "data", dim=0) if has_data else x
            di = comm.axis_index("data") if has_data else 0
            e_off = (di * dist.axis_size("model")
                     + comm.axis_index("model")) * n_local
            y, aux = M.apply_moe(
                xg, mp, cfg, router_mode=self.router_mode, e_offset=e_off,
                combine_axes=tuple(a for a in ("data", "model")
                                   if a in dist.axis_names),
                combine_dtype=self.dtype,
                shared_scale=1.0 / dist.axis_size("data"), dist=dist)
            if has_data:
                y = y[di * x.shape[0]:(di + 1) * x.shape[0]]
            return y, comm.pmean(aux, all_axes)
        y, aux = M.apply_moe(x, mp, cfg, router_mode=self.router_mode,
                             ep_axis="model" if self.moe_ep else None,
                             tp_axis=None if self.moe_ep else "model",
                             dist=dist)
        return y, comm.pmean(aux, dist.dp)

    def _ffn(self, x, fp):
        """(y, aux loss): the MoE's, or None for a dense MLP (a row-split
        ``down``'s partial sums summed over `model`)."""
        if self.cfg.moe is not None:
            return self._moe(x, fp)
        return self._mlp(x, fp), None

    def _mlp(self, x, fp):
        """The dense MLP; on a mesh a row-split ``down``'s partial sums
        summed over `model` (``common.mlp``)."""
        return C.mlp(x, fp, self.cfg, self.dist)

    def _layer(self, x, lp, win, theta, positions, cache_entry, length,
               mode, fsdp=None):
        """(x, aux loss) after one layer.  ``fsdp``: the layers' (specs,
        full shapes) where the layer's leaves are gathered over `data`
        first (training on a mesh)."""
        cfg = self.cfg
        if fsdp is not None:
            lp = S.fsdp_gather(lp, *fsdp, self.dist, lead=1)
        h = L.apply_norm(x, lp["ln1"], cfg)
        if mode == "decode":
            attn = self._attention_decode(h, lp["attn"], win, theta,
                                          cache_entry, length)
        else:
            attn = self._attention_full(h, lp["attn"], win, theta,
                                        positions, cache_entry)
        x = x + C.mul_scalar(attn, self.residual_scale)
        h = L.apply_norm(x, lp["ln2"], cfg)
        ffn, aux = self._ffn(h, lp["ffn"])
        return x + C.mul_scalar(ffn, self.residual_scale), aux

    # ------------------------------------------------------------- forwards

    def _run_layers(self, x, params, positions, cache, length, mode,
                    remat=False, fsdp=None):
        """(x, aux) after every layer.  mode "prefill" fills ``cache``
        from position 0, "decode" writes it at ``length``, "train" runs
        without a cache (cache None) and sums the layers' MoE aux losses
        into ``aux`` (0 for a dense model; None in the other modes, where
        nothing reads it).  With ``remat`` ("train" only) each layer runs
        under activation checkpointing with ``remat_policy``; ``fsdp``:
        ``_layer``'s."""
        win, theta = layer_scalars(self.cfg)
        layers = C.unstack_layers(params["layers"], self.cfg.n_layers)
        aux = x.new_zeros((), dtype=torch.float32) if mode == "train" \
            else None
        for l, lp in enumerate(layers):
            ce = None if cache is None else C.index_layer(cache, l)
            args = (x, lp, win[l], theta[l], positions, ce, length, mode,
                    fsdp)
            if remat:
                # no layer draws random numbers: no RNG state to keep
                x, a = ckpt.checkpoint(self._layer, *args,
                                       use_reentrant=False,
                                       preserve_rng_state=False,
                                       context_fn=self._remat_context)
            else:
                x, a = self._layer(*args)
            if aux is not None and a is not None:
                aux = aux + a
        return x, aux

    def _remat_context(self):
        """What a checkpointed layer keeps: nothing (policy None: the
        whole layer is recomputed in the backward), or with "dots" the
        outputs of its matrix products, as jax's ``checkpoint_dots``."""
        if self.remat_policy is None:
            return ckpt.noop_context_fn()
        if self.remat_policy != "dots":
            raise ValueError(f"remat_policy {self.remat_policy!r}: None or "
                             f"'dots'")
        return ckpt.create_selective_checkpoint_contexts(_save_dots)

    def loss(self, params, batch):
        """batch: tokens (b, s), labels (b, s), optional loss_mask (b, s),
        optional patch_embeds (b, P, d).  Returns (xent [+ 0.3 mtp] + aux,
        {"xent", "aux_loss"[, "mtp"]}), every layer under activation
        checkpointing."""
        cfg, dist = self.cfg, self.dist
        fsdp = None
        if dist.active:
            if self.moe_full_ep and self.full_ep_available():
                raise NotImplementedError(
                    "training with moe_full_ep: full expert parallelism is "
                    "the reference's decode layout (launch/specs.py)")
            specs, shapes = self.layout()
            params = {k: (v if k == self.STACK else
                          S.fsdp_gather(v, specs[k], shapes[k], dist))
                      for k, v in params.items()}
            fsdp = (specs[self.STACK], shapes[self.STACK])
        patches = batch.get("patch_embeds")
        x = self._embed_inputs(params, batch["tokens"], patches)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, aux = self._run_layers(x, params, positions, None, None,
                                  "train", remat=True,
                                  **({"fsdp": fsdp} if fsdp else {}))
        x = L.apply_norm(x, params["final_norm"], cfg)
        if patches is not None:
            x = x[:, patches.shape[1]:]
        logits = C.lm_logits(x, params["embed"], cfg, dist, gather=False)
        # The reference's next_token_loss: its one-hot einsum picks exactly
        # logits[label] (every other term of the sum is +-0), so
        # softmax_xent's gather gives the same bits without the (b, s, V)
        # one-hot.
        xent = C.next_token_loss(logits, batch["labels"],
                                 batch.get("loss_mask"), cfg, dist)
        metrics = {"xent": xent, "aux_loss": aux}
        loss = xent
        if cfg.mtp_depth:
            mtp = self._mtp_loss(params, x, batch)
            loss = loss + 0.3 * mtp
            metrics["mtp"] = mtp
        return loss + aux, metrics

    def _mtp_loss(self, params, h, batch):
        """The reference's depth-1 multi-token prediction: ``h`` (after
        ``final_norm``) normed again by ``mtp/norm``, joined with the
        embeddings of the labels rolled by -1 (the roll wraps), projected,
        one more layer (the last layer's window and theta, no remat, its
        MoE aux loss dropped), then cross entropy against the labels
        rolled by -1 with the last two positions masked."""
        cfg, dist, mtp = self.cfg, self.dist, params["mtp"]
        labels2 = torch.roll(batch["labels"], -1, dims=1)
        emb_next = C.embed(labels2, params["embed"], cfg, dist)
        hn = L.rmsnorm(h, mtp["norm"], cfg.norm_eps)
        x = C.col_product(torch.cat([hn, emb_next], dim=-1), mtp["proj"],
                          cfg.d_model, dist)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        win, theta = layer_scalars(cfg)
        x, _ = self._layer(x, mtp["layer"], win[-1], theta[-1], positions,
                           None, None, "train")
        logits = C.lm_logits(x, params["embed"], cfg, dist, gather=False)
        mask = torch.ones(labels2.shape, dtype=torch.float32,
                          device=labels2.device)
        mask[:, -2:] = 0.0
        return C.next_token_loss(logits, labels2, mask, cfg, dist)

    def _embed_inputs(self, params, tokens, patch_embeds=None):
        """Token embeddings, with ``patch_embeds`` (b, P, d) in front."""
        x = C.embed(tokens, params["embed"], self.cfg, self.dist)
        if patch_embeds is not None:
            x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        return x

    def prefill(self, params, tokens, max_len, patch_embeds=None):
        """tokens (b, s) and optional patch_embeds (b, P, d) -> (last-
        position logits (b, 1, V), cache, length P + s).  The cache is
        allocated at max_len + P slots and filled."""
        x = self._embed_inputs(params, tokens, patch_embeds)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        cache = self.init_cache(tokens.shape[0], max_len, x.device,
                                extra=x.shape[1] - tokens.shape[1])
        x = self._run_layers(x, params, positions, cache, None,
                             "prefill")[0]
        x = L.apply_norm(x[:, -1:], params["final_norm"], self.cfg)
        logits = C.lm_logits(x, params["embed"], self.cfg, self.dist)
        return logits, cache, positions.shape[1]

    def decode(self, params, cache, tokens, length):
        """tokens (b, 1); ``length`` = number of valid cache entries (a
        Python int).  Writes the cache in place and returns (logits
        (b, 1, V), cache, length + 1)."""
        x = self._embed_inputs(params, tokens)
        x = self._run_layers(x, params, None, cache, length, "decode")[0]
        x = L.apply_norm(x, params["final_norm"], self.cfg)
        logits = C.lm_logits(x, params["embed"], self.cfg, self.dist)
        return logits, cache, length + 1

    # -------------------------------------------------------------- caches

    def cache_specs(self):
        """Specs matching ``init_cache``'s (whole) layout."""
        dp = self.dist.batch_axes()
        kv = self.dist.kv_axes()
        if self.cfg.mla is not None:
            return {"ckv": (None, dp, kv, None),
                    "krope": (None, dp, kv, None)}
        return {"k": (None, dp, kv, None, None),
                "v": (None, dp, kv, None, None)}

    def init_cache(self, batch, max_len, device, extra=0):
        """Zero caches of max_len + extra slots (extra: a vision
        prefix's patches); MLA's holds the latents.  On a mesh, this
        rank's block: ``batch`` is its rows, and it holds its share of the
        slots, which must divide over ``dist.kv_seq``."""
        cfg = self.cfg
        S, n = max_len + extra, self._kv_shards()
        if S % n:
            raise ValueError(f"{S} cache slots do not divide over "
                             f"{self.dist.kv_seq} ({n} ranks)")
        lead = (cfg.n_layers, batch, S // n)
        if cfg.mla is not None:
            return {"ckv": torch.zeros((*lead, cfg.mla.kv_lora_rank),
                                       dtype=self.dtype, device=device),
                    "krope": torch.zeros((*lead, cfg.mla.qk_rope_head_dim),
                                         dtype=self.dtype, device=device)}
        shape = (*lead, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=device),
                "v": torch.zeros(shape, dtype=self.dtype, device=device)}


# the matrix products whose outputs remat_policy "dots" keeps, as jax's
# checkpoint_dots keeps every dot_general's: bmm.dtype is the MoE's
# f32-output expert product on the card (moe.py::_bmm_f32)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.bmm.dtype, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
