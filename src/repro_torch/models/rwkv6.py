"""RWKV6 "Finch" block: the port of ``repro.models.rwkv6``.

Data-dependent-decay time mix (ddlerp token shift with a 5-way LoRA mix,
LoRA decay, the per-head WKV recurrence, a per-head group norm) and the
squared-ReLU channel mix.  Heads are d_model/head_dim wide.  Params keep
the reference's names, shapes and ``x @ W`` orientation.

Reproduced from the reference as it is, not fixed: the group norm is the
population variance with eps 64e-5 in f32; the decay
``w = exp(-exp(w0 + dw))`` is computed in f32 from ``dw`` in the model
dtype, so the recurrence gets w in f32 and r/k/v/u in the model dtype;
a one-token input takes the step path even in prefill.

On a mesh (``dist`` active; ``sharding.py``'s rules) each rank computes
its H/tp heads.  The time mix takes x whole over `model`: wr, wk, wv,
wg and ``decay_w2`` are split by columns, so r, k, v, g and w are the
rank's heads; ``mix_w2`` (5, lora, d), split over d, is all-gathered
whole (its all-gather's backward keeps the rank's block: the deltas and
everything upstream of the split products hold whole gradients), so the
five mixed inputs are the reference's bits; ``w0``, ``u`` and
``ln_scale`` are sliced at the rank's first head
(``common.local_block``); K2 and the per-head group norm run on the
local heads; ``(y * g) @ wo`` with wo split by rows is summed over
`model`.  The channel mix's wk is split by columns and wv by rows, so
``k @ wv`` is a partial sum: it is reduce-scattered over `model` to the
rank's d/tp columns, gated there by ``sigmoid(xr @ wr)`` (wr split by
columns: the rank's d/tp gate columns), and all-gathered, the bytes of
one all-reduce, with no gathered gate.  Each value every rank holds
whole enters a split product through ``comm.enter``
(``collectives.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models import common as C
from repro_torch.models import layers as L

MIX_KEYS = ("r", "k", "v", "w", "g")


def init_time_mix(generator, cfg, dtype, device, lead=()):
    d = cfg.d_model
    rw = cfg.rwkv
    dense = lambda shape, fan_in=None: L.dense_init(  # noqa: E731
        generator, shape, dtype, device, fan_in=fan_in, lead=lead)
    full = lambda shape, v: torch.full(  # noqa: E731
        (*lead, *shape), v, dtype=dtype, device=device)
    u = torch.randn((*lead, d), generator=generator, device=device,
                    dtype=torch.float32) * 0.1
    return {
        "mu_x": full((d,), 0.0),
        "mu": full((5, d), 0.0),
        "mix_w1": dense((d, 5 * rw.mix_lora)),
        "mix_w2": dense((5, rw.mix_lora, d), fan_in=rw.mix_lora),
        "w0": full((d,), -6.0),
        "decay_w1": dense((d, rw.decay_lora)),
        "decay_w2": dense((rw.decay_lora, d), fan_in=rw.decay_lora),
        "u": u.to(dtype),
        "wr": dense((d, d)),
        "wk": dense((d, d)),
        "wv": dense((d, d)),
        "wg": dense((d, d)),
        "wo": dense((d, d)),
        "ln_scale": full((d,), 1.0),
    }


def init_channel_mix(generator, cfg, dtype, device, lead=()):
    d, ff = cfg.d_model, cfg.d_ff
    zeros = torch.zeros((*lead, d), dtype=dtype, device=device)
    return {
        "mu_k": zeros,
        "mu_r": zeros.clone(),
        "wk": L.dense_init(generator, (d, ff), dtype, device, lead=lead),
        "wv": L.dense_init(generator, (ff, d), dtype, device, lead=lead),
        "wr": L.dense_init(generator, (d, d), dtype, device, lead=lead),
    }


def _token_shift(x, last):
    """shift(x)_t - x_t, with shift(x)_t = x_{t-1} and ``last`` (the
    decode carry) at position 0."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1) - x


def time_mix(x, p, cfg, state, last_x, dist=None):
    """x (b, s, d); state (b, H, hd, hd) wkv state (this rank's H/tp heads
    on a mesh); last_x (b, d) shift carry.  Returns y, (new_state,
    new_last_x)."""
    b, s, d = x.shape
    hd = cfg.rwkv.head_dim
    d_l = p["wr"].shape[-1]           # this rank's channels
    H = d_l // hd
    split = d_l < d
    xx = _token_shift(x, last_x)
    xxx = x + xx * p["mu_x"]
    mix = torch.tanh(xxx @ p["mix_w1"]).reshape(b, s, 5, -1)
    mix_w2 = p["mix_w2"]
    if mix_w2.shape[-1] < d:
        mix_w2 = dist.comm.all_gather(mix_w2, dist.tp, dim=-1)
    deltas = torch.einsum("bsfl,fld->bsfd", mix, mix_w2)
    mixed = {key: x + xx * (p["mu"][i] + deltas[:, :, i])
             for i, key in enumerate(MIX_KEYS)}

    def enter(t):
        return C.enter_split(t, split, dist)

    r = (enter(mixed["r"]) @ p["wr"]).reshape(b, s, H, hd)
    k = (enter(mixed["k"]) @ p["wk"]).reshape(b, s, H, hd)
    v = (enter(mixed["v"]) @ p["wv"]).reshape(b, s, H, hd)
    g = L.silu(enter(mixed["g"]) @ p["wg"])

    dw = enter(torch.tanh(mixed["w"] @ p["decay_w1"])) @ p["decay_w2"]
    w0 = C.local_block(p["w0"], d_l, dist)
    w = torch.exp(-torch.exp(w0.float() + dw.float()))
    w = w.reshape(b, s, H, hd)

    u = C.local_block(p["u"], d_l, dist).reshape(H, hd)
    if s == 1:
        y, new_state = wkv_ops.wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                                         u, state)
        y = y[:, None]
    else:
        y, new_state = wkv_ops.wkv6(r, k, v, w, u, state)
    # per-head group norm
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, correction=0)
    yf = (yf - mu) * torch.rsqrt(var + 64e-5)
    scale = C.local_block(p["ln_scale"], d_l, dist)
    y = (yf.reshape(b, s, d_l) * scale.float()).to(x.dtype)
    out = C.row_sum((y * g) @ p["wo"], p["wo"].shape[-2], d, dist)
    return out, (new_state, x[:, -1, :])


def channel_mix(x, p, last_x, dist=None):
    xx = _token_shift(x, last_x)
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    if p["wr"].shape[-1] == x.shape[-1]:
        k = torch.square(torch.relu(xk @ p["wk"]))
        return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1, :]
    comm, tp = dist.comm, dist.tp
    k = torch.square(torch.relu(comm.enter(xk, tp) @ p["wk"]))
    kv = comm.psum_scatter(k @ p["wv"], tp, dim=-1)
    gate = torch.sigmoid(comm.enter(xr, tp) @ p["wr"])
    return comm.all_gather(gate * kv, tp, dim=-1), x[:, -1, :]


def init_state(cfg, batch, dtype=torch.float32, device="cpu"):
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    H = d // hd
    return {
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        "tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_x": torch.zeros((batch, d), dtype=dtype, device=device),
    }
