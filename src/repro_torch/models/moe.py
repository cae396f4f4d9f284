"""Mixture-of-Experts: top-k routing with capacity, on one device or
sharded over a mesh; the port of ``repro.models.moe``.

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

On a mesh (the reference's ``shard_map`` bodies, run as explicit SPMD
with ``dist``'s collectives) ``apply_moe`` takes the reference's sharding
arguments: ``ep_axis`` (this rank's slice of the experts, its offset from
its index on that axis), ``tp_axis`` (every expert, this rank's slice of
each expert's hidden dim), or full expert parallelism's explicit
``e_offset`` with ``combine_axes``, ``combine_dtype`` and
``shared_scale``.  Assignments to other ranks' experts drop into the
trash row as overflow does, in the same token-major order, and the
combine is one psum.  Every rank of the split routes the same tokens, so
the routing and its aux loss are whole on each; the tokens and the gates
enter the split experts' computation (``comm.enter``: their gradients
are psum'd over the axis in the backward, ``collectives.py``).  A rank
whose experts receive no token still runs every product and collective
(the dispatch buffer's rows are zeros), so the ranks' collectives stay in
step in the backward too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

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
    CPU's bmm has no such output, so there the operands are converted.
    That overload has no derivative, so on the card a product that needs
    a gradient goes through ``_BmmF32``, whose forward is the same call."""
    if a.is_cuda and a.dtype != torch.float32:
        if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
            return _BmmF32.apply(a, w)
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.float(), w.float())


def bmm_f32_grads(a, w, g):
    """The gradients of ``a @ w`` (f32 output) for an f32 cotangent ``g``,
    as JAX transposes an einsum with ``preferred_element_type=f32``: g
    against the other operand in f32, rounded to each operand's dtype.
    One expert at a time, so the f32 copies are one expert's (d, d_e),
    never the whole (E, d, d_e) stack."""
    da = torch.empty_like(a)
    dw = torch.empty_like(w)
    for e in range(a.shape[0]):
        da[e] = (g[e] @ w[e].float().T).to(a.dtype)
        dw[e] = (a[e].float().T @ g[e]).to(w.dtype)
    return da, dw


class _BmmF32(torch.autograd.Function):
    """``torch.bmm(a, w, out_dtype=torch.float32)`` with the backward of
    ``bmm_f32_grads``."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.bmm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        da, dw = bmm_f32_grads(a, w, g.float())
        return (da if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None)


def apply_moe(x, p, cfg, *, router_mode="softmax_topk", ep_axis=None,
              tp_axis=None, e_offset=None, combine_axes=None,
              combine_dtype=None, shared_scale=1.0, dist=None):
    """x (b, s, d) -> (y (b, s, d) in x.dtype, aux_loss).

    Sharding modes (at most one; none on one device), each needing the
    mesh context ``dist`` for its collectives:
      * ``ep_axis``: ``p["gate"]`` et al. hold this rank's slice of the
        experts, from its index on that axis; the aux loss is averaged and
        the output summed over it;
      * ``tp_axis``: every expert, this rank's slice of each expert's
        hidden dim (and of the shared experts'); the output is summed
        over it;
      * full EP: the caller's ``e_offset`` (experts over several axes)
        and ``combine_axes``; ``combine_dtype`` (e.g. bf16) for the
        combine's psum; ``shared_scale`` for a shared expert computed
        again on every rank of an axis the combine sums over but its
        weights do not split.
    """
    axis = combine_axes or ep_axis or tp_axis
    if axis is not None and (dist is None or not dist.active):
        raise ValueError(f"the mesh axes {axis!r} need an active "
                         f"MeshContext (dist=)")
    m = cfg.moe
    b, s, d = x.shape
    T = b * s
    xf = x.reshape(T, d)
    idx, gates, aux = route(xf, p["router"], m, router_mode)

    n_local = p["gate"].shape[0]                 # E, or this rank's slice
    if e_offset is None:
        e_offset = 0
        if ep_axis is not None:
            # the reference's pmean of aux over ep_axis: every rank there
            # routed the same tokens, so the mean is the value itself
            e_offset = dist.comm.axis_index(ep_axis) * n_local
    if axis is not None:
        xf = dist.comm.enter(xf, axis)
        gates = dist.comm.enter(gates, axis)
    C = _capacity(T, m)

    # position of each (token, k) assignment within its expert's queue
    flat_e = idx.reshape(-1)                                   # (T*k,)
    onehot = F.one_hot(flat_e, m.n_experts)
    pos = (torch.cumsum(onehot, dim=0) * onehot).amax(dim=-1) - 1
    local_e = flat_e - e_offset
    valid = (pos < C) & (local_e >= 0) & (local_e < n_local)
    slot = torch.where(valid, local_e * C + pos, n_local * C)  # overflow

    # dispatch: (n_local*C + 1, d), the last row the trash slot (written
    # by every dropped or other rank's assignment, in no defined order, and
    # never read)
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(m.top_k)
    buf = torch.zeros((n_local * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, xf[tok_idx])
    ebuf = buf[:n_local * C].view(n_local, C, d)

    act = L.silu if cfg.act == "silu" else L.gelu
    h = act(_bmm_f32(ebuf, p["gate"])) * _bmm_f32(ebuf, p["up"])
    y_e = _bmm_f32(h.to(x.dtype), p["down"])              # (E_l, C, d)

    # combine: gate-weighted f32 scatter-add back to the tokens; the
    # trash slot reads as zeros
    y_flat = torch.cat([y_e.reshape(n_local * C, d),
                        y_e.new_zeros((1, d))])
    w = gates.reshape(-1) * valid
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok_idx, y_flat[slot] * w[:, None])
    if m.n_shared_experts:
        shared = L.apply_mlp(xf, p["shared"], cfg.act).float()
        y = y + (shared if shared_scale == 1.0 else shared * shared_scale)
    if axis is not None:
        if combine_dtype is not None:
            y = y.to(combine_dtype)
        y = dist.comm.psum(y, axis)              # single combine all-reduce
    return y.to(x.dtype).reshape(b, s, d), aux
