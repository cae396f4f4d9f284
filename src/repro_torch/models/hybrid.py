"""Jamba-style hybrid LM: the port of ``repro.models.hybrid``.

Periods of one attention layer and ``period - 1`` Mamba layers, with MoE
on every ``moe.layer_period``-th layer and a dense MLP on the rest.  The
reference scans over periods with a static loop over each period's
layers; here both are Python loops.  Params keep the reference's layout:
``periods/...`` stacked on a leading (P, ...) dim, and within a period
the Mamba, MoE and MLP weights stacked again on the layer's index among
its kind, e.g. ``periods/mamba/in_proj`` (P, n_mamba, d, 2 di).

Prefill runs the attention layer through the flash attention kernel
(K1) and every Mamba layer of more than one token through the selective
scan kernel (K3); decode takes the plain one-step paths.  The cache keeps
the reference's layout, ``{attn: {k, v: (P, b, S, n_kv, hd)}, mamba:
{ssm: (P, n_mamba, b, di, N) f32, conv: (P, n_mamba, b, K-1, di)}}``, and
prefill and decode write it in place.

``loss`` is ``DecoderLM.loss``: next-token cross entropy plus the MoE
layers' aux losses, each period under activation checkpointing (the
reference's ``jax.checkpoint`` of the scanned period, with no policy).
On the card its gradient runs through K1's and K3's backward kernels.

``JambaLM(cfg, dist, long_context)`` serves and trains on a ("data",
"model") mesh as ``DecoderLM`` does (explicit SPMD; ``transformer.py``):
the attention layer is the parent's (this rank's q heads through K1, kv
replicated; Jamba has no RoPE), the MoE layers the parent's ``_moe``
(EP where the experts divide `model`; capacity and aux each `data`
shard's), the dense MLP the parent's ``_mlp`` (``down`` summed over
`model`), and each Mamba layer runs on the rank's di/tp channels
(``mamba.py``).  ``loss`` gathers a period's FSDP leaves over `data`
inside its checkpointed period.  The cache on a mesh (``cache_specs``):
the attention's k/v with the rank's rows and its slots over
``dist.kv_seq``, the Mamba states with the rank's rows and channels.
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.distribution import sharding as S
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as M
from repro_torch.models.transformer import DecoderLM


class JambaLM(DecoderLM):
    """Reuses DecoderLM's attention, MoE, MLP, embedding, ``loss``,
    ``prefill`` and ``decode``; replaces the layer stack with the hybrid
    periods."""

    STACK = "periods"

    def __init__(self, cfg, dist=None, long_context=False):
        super().__init__(cfg, dist)
        self.period = cfg.attn_layer_period
        if cfg.n_layers % self.period:
            raise ValueError(f"{cfg.n_layers} layers are not whole periods "
                             f"of {self.period}")
        self.n_periods = cfg.n_layers // self.period
        self.n_mamba = self.period - 1
        mo = cfg.moe.layer_offset
        self.moe_js = [j for j in range(self.period)
                       if j % cfg.moe.layer_period == mo]
        self.mlp_js = [j for j in range(self.period) if j not in self.moe_js]
        self.long_context = long_context

    @property
    def attn_window(self):
        return self.cfg.hybrid_long_window if self.long_context else 0

    # ------------------------------------------------------------------ init

    def init(self, generator, device=None):
        """Random params drawn from ``generator`` (which must live on
        ``device``; the card by default), each weight drawn straight into
        its stacked tensor: the peak is the model's size and one draw
        block (``layers.DRAW_BLOCK``), not a period above it."""
        device = resolve_device(device)
        cfg, dt, P = self.cfg, self.dtype, self.n_periods

        periods = {
            "attn": A.init_attention(generator, cfg, dt, device, lead=(P,)),
            "mamba": MB.init_mamba(generator, cfg, dt, device,
                                   lead=(P, self.n_mamba)),
            "moe": M.init_moe(generator, cfg, dt, device,
                              lead=(P, len(self.moe_js))),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, dt,
                              device, lead=(P, len(self.mlp_js))),
            "ln1": L.init_norm(cfg, dt, device, lead=(P, self.period)),
            "ln2": L.init_norm(cfg, dt, device, lead=(P, self.period)),
        }
        return {
            "embed": C.init_embedding(generator, cfg, dt, device),
            "periods": periods,
            "final_norm": L.init_norm(cfg, dt, device),
        }

    # ------------------------------------------------------------- forward

    def _period_block(self, x, pp, positions, ce, length, mode, fsdp=None):
        """(x, aux) after one period.  ``ce`` holds this period's cache
        views, written in place (None: a cache-free forward from a zero
        state).  aux: in "train" the sum of the period's MoE aux losses
        in layer order (an f32 0 without MoE layers), else None.
        ``fsdp``: the periods' (specs, full shapes) where the period's
        leaves are gathered over `data` first (training on a mesh)."""
        cfg = self.cfg
        if fsdp is not None:
            pp = S.fsdp_gather(pp, *fsdp, self.dist, lead=1)
        aux = x.new_zeros((), dtype=torch.float32) if mode == "train" \
            else None
        mi = moei = mlpi = 0
        for j in range(self.period):
            h = L.apply_norm(x, {"scale": pp["ln1"]["scale"][j]}, cfg)
            if j == cfg.attn_layer_offset:
                if mode == "decode":
                    o = self._attention_decode(h, pp["attn"],
                                               self.attn_window,
                                               cfg.rope_theta, ce["attn"],
                                               length)
                else:
                    o = self._attention_full(
                        h, pp["attn"], self.attn_window, cfg.rope_theta,
                        positions, None if ce is None else ce["attn"])
            else:
                st = None if ce is None else C.index_layer(ce["mamba"], mi)
                o, new = MB.apply_mamba(h, C.index_layer(pp["mamba"], mi),
                                        cfg, st, self.dist)
                if st is not None:
                    st["ssm"].copy_(new["ssm"])
                    st["conv"].copy_(new["conv"])
                mi += 1
            x = x + o
            h = L.apply_norm(x, {"scale": pp["ln2"]["scale"][j]}, cfg)
            if j in self.moe_js:
                y, a = self._moe(h, C.index_layer(pp["moe"], moei))
                if aux is not None:
                    aux = aux + a
                moei += 1
            else:
                y = self._mlp(h, C.index_layer(pp["mlp"], mlpi))
                mlpi += 1
            x = x + y
        return x, aux

    def _run_layers(self, x, params, positions, cache, length, mode,
                    remat=False, fsdp=None):
        """As ``DecoderLM._run_layers``, a period at a time: "prefill"
        fills ``cache``, "decode" writes it at ``length``, "train" runs
        without one and sums the periods' aux losses (None in the other
        modes).  With ``remat`` ("train" only) each period runs under
        activation checkpointing with no policy, whatever
        ``remat_policy`` says: the reference's ``JambaLM._run_layers``
        checkpoints each period without one, so the whole period is
        recomputed in the backward.  ``fsdp``: ``_period_block``'s."""
        aux = x.new_zeros((), dtype=torch.float32) if mode == "train" \
            else None
        for p in range(self.n_periods):
            ce = None if cache is None else C.index_layer(cache, p)
            args = (x, C.index_layer(params["periods"], p), positions, ce,
                    length, mode, fsdp)
            if remat:
                # no layer draws random numbers: no RNG state to keep
                x, a = ckpt.checkpoint(self._period_block, *args,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                x, a = self._period_block(*args)
            if aux is not None:
                aux = aux + a
        return x, aux

    # -------------------------------------------------------------- caches

    def prefill(self, params, tokens, max_len, patch_embeds=None):
        """As the reference's JambaLM.prefill, which takes
        ``patch_embeds`` and drops it."""
        return super().prefill(params, tokens, max_len)

    def cache_specs(self):
        """Specs matching ``init_cache``'s (whole) layout: the
        reference's (``src/repro/models/hybrid.py:174-183``)."""
        dp = self.dist.batch_axes()
        kv = self.dist.kv_axes()
        return {"attn": {"k": (None, dp, kv, None, None),
                         "v": (None, dp, kv, None, None)},
                "mamba": {"ssm": (None, None, dp, "model", None),
                          "conv": (None, None, dp, None, "model")}}

    def init_cache(self, batch, max_len, device, extra=0):
        """Zero caches; on a mesh, this rank's block: ``batch`` is its
        rows, and it holds its share of the attention's slots (which must
        divide over ``dist.kv_seq``) and its Mamba channels."""
        cfg = self.cfg
        mc = cfg.mamba
        di = S.local_width(mc.expand * cfg.d_model, self.dist)
        P, nm = self.n_periods, self.n_mamba
        slots, n = max_len + extra, self._kv_shards()
        if slots % n:
            raise ValueError(f"{slots} cache slots do not divide over "
                             f"{self.dist.kv_seq} ({n} ranks)")
        kv = (P, batch, slots // n, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {
            "attn": {"k": torch.zeros(kv, dtype=self.dtype, device=device),
                     "v": torch.zeros(kv, dtype=self.dtype, device=device)},
            "mamba": {
                "ssm": torch.zeros((P, nm, batch, di, mc.d_state),
                                   dtype=torch.float32, device=device),
                "conv": torch.zeros((P, nm, batch, mc.d_conv - 1, di),
                                    dtype=self.dtype, device=device),
            },
        }
