"""Mixture-of-Experts on one device: the port of ``repro.models.moe``.

Top-k routing with a per-expert capacity, two router flavours
("softmax_topk": Mixtral, Jamba; "sigmoid": DeepSeek-V3) and the
Switch/GShard load-balancing aux loss.  Expert weights are stacked:
(E, d, d_e) gate and up, (E, d_e, d) down.

What the reference does, kept here:
  * top-k ties go to the lower expert index (``jax.lax.top_k``): a stable
    descending sort, where ``torch.topk`` promises no order for ties;
  * each (token, k) assignment's position in its expert's queue is a
    cumsum over token-major (T*k) order, so that order decides which
    assignments a full expert drops;
  * dispatch copies tokens into an (E*C + 1, d) buffer whose last row is
    the overflow slot, a trash row that every dropped assignment writes
    and that the combine reads as zeros;
  * the combine is an f32 scatter-add of the gate-weighted expert outputs
    back to the tokens.
The expert products are batched ``torch.bmm`` with f32 outputs of
operands in the model dtype (``_bmm_f32``), as the reference's einsums
with ``preferred_element_type=f32``: gate, up, the activation product and
the down projection stay f32, and only the hidden ``h`` is rounded to the
model dtype, once.

Only the single-device mode is ported: the reference's expert- and
tensor-parallel modes (``ep_axis``, ``tp_axis``, ``e_offset``,
``combine_axes``, ``combine_dtype``, and ``shared_scale``, which only
full expert parallelism sets) come with the multi-device layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

MESH_ITEM = "MoE expert/tensor parallelism: ROADMAP Queue 1 item 12"


def init_moe(generator, cfg, dtype, device, lead=()):
    m, d = cfg.moe, cfg.d_model
    kw = dict(lead=lead)
    p = {
        "router": L.dense_init(generator, (d, m.n_experts), dtype, device,
                               fan_in=d, **kw),
        "gate": L.dense_init(generator, (m.n_experts, d, m.d_expert), dtype,
                             device, fan_in=d, **kw),
        "up": L.dense_init(generator, (m.n_experts, d, m.d_expert), dtype,
                           device, fan_in=d, **kw),
        "down": L.dense_init(generator, (m.n_experts, m.d_expert, d), dtype,
                             device, fan_in=m.d_expert, **kw),
    }
    if m.n_shared_experts:
        ff = m.d_expert * m.n_shared_experts
        p["shared"] = L.init_mlp(generator, d, ff, "silu", dtype, device,
                                 lead=lead)
    return p


def top_k(x, k):
    """``jax.lax.top_k`` over the last dim: the k largest values in
    descending order, ties broken towards the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x_flat, router_w, m, router_mode):
    """x_flat (T, d) -> (expert_idx (T, k) int64, gates (T, k) f32,
    aux_loss f32 scalar)."""
    logits = (x_flat @ router_w).float()                       # (T, E)
    if router_mode == "sigmoid":
        gates, idx = top_k(torch.sigmoid(logits), m.top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    else:
        top_logits, idx = top_k(logits, m.top_k)
        gates = torch.softmax(top_logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.zeros(m.n_experts, dtype=torch.float32,
                              device=logits.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=logits.device)
    ) / idx.numel()
    frac_probs = probs.mean(dim=0)
    aux = m.n_experts * torch.sum(frac_tokens * frac_probs) * m.aux_loss_coef
    return idx, gates.float(), aux


def _capacity(n_tokens, m):
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _bmm_f32(a, w):
    """``a @ w`` batched, with f32 outputs of operands in their own dtype.
    On the card cuBLAS writes the f32 output of bf16 operands directly
    (``out_dtype``), so the (E, d, d_e) weights are never converted; the
    CPU's bmm has no such output, so there the operands are converted."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.float(), w.float())


def apply_moe(x, p, cfg, *, router_mode="softmax_topk", ep_axis=None,
              tp_axis=None, e_offset=None, combine_axes=None,
              combine_dtype=None):
    """x (b, s, d) -> (y (b, s, d) in x.dtype, aux_loss).  One device:
    the reference's sharding arguments raise unless None."""
    mesh = dict(ep_axis=ep_axis, tp_axis=tp_axis, e_offset=e_offset,
                combine_axes=combine_axes, combine_dtype=combine_dtype)
    given = sorted(k for k, v in mesh.items() if v is not None)
    if given:
        raise NotImplementedError(f"{given}: {MESH_ITEM}")
    m = cfg.moe
    b, s, d = x.shape
    T = b * s
    xf = x.reshape(T, d)
    idx, gates, aux = route(xf, p["router"], m, router_mode)
    E = p["gate"].shape[0]
    C = _capacity(T, m)

    # position of each (token, k) assignment within its expert's queue
    flat_e = idx.reshape(-1)                                   # (T*k,)
    onehot = F.one_hot(flat_e, m.n_experts)
    pos = (torch.cumsum(onehot, dim=0) * onehot).amax(dim=-1) - 1
    valid = pos < C
    slot = torch.where(valid, flat_e * C + pos, E * C)         # overflow slot

    # dispatch: (E*C + 1, d), the last row the trash slot (written by
    # every dropped assignment, in no defined order, and never read)
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(m.top_k)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, xf[tok_idx])
    ebuf = buf[:E * C].view(E, C, d)

    act = L.silu if cfg.act == "silu" else L.gelu
    h = act(_bmm_f32(ebuf, p["gate"])) * _bmm_f32(ebuf, p["up"])
    y_e = _bmm_f32(h.to(x.dtype), p["down"])                   # (E, C, d)

    # combine: gate-weighted f32 scatter-add back to the tokens; the
    # trash slot reads as zeros
    y_flat = torch.cat([y_e.reshape(E * C, d),
                        y_e.new_zeros((1, d))])
    w = gates.reshape(-1) * valid
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok_idx, y_flat[slot] * w[:, None])
    if m.n_shared_experts:
        y = y + L.apply_mlp(xf, p["shared"], cfg.act).float()
    return y.to(x.dtype).reshape(b, s, d), aux
