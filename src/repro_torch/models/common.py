"""Shared LM plumbing: embeddings, heads, residual scaling."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def init_embedding(generator, cfg, dtype, device):
    p = {"tokens": L.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                dtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                    dtype, device)
    return p


def mul_scalar(x, scale):
    """x * scale with the scale first rounded to x's dtype, as
    jnp.asarray(scale, x.dtype) does.  The rounding happens on the host:
    a scalar tensor made on the card per call would wait for the card."""
    if scale == 1.0:
        return x
    return x * torch.tensor(scale, dtype=x.dtype).item()


def _vocab_split(n_local, cfg, dist):
    """Whether a table holds ``n_local`` of the vocab's rows because a
    mesh's rule split it over `model` (one device: never)."""
    return dist is not None and dist.active and n_local < cfg.vocab_size


def _vocab0(n_local, cfg, dist):
    """This rank's first vocab row of a table split over `model`."""
    return dist.comm.axis_index(dist.tp) * n_local


def embed(tokens, p, cfg, dist=None):
    """The reference's jnp.take.  On a mesh whose rule split the table's
    vocab over `model`, a masked lookup into this rank's rows (zeros for
    other ranks' tokens) summed over `model`: exactly the take.
    F.embedding's CUDA backward sums the rows of repeated tokens after a
    sort, with no atomics, so a training step gives the same bits each
    time (chip_smoke.py checks it on the card)."""
    table = p["tokens"]
    tokens = tokens.long()
    if not _vocab_split(table.shape[0], cfg, dist):
        x = F.embedding(tokens, table)
    else:
        local = tokens - _vocab0(table.shape[0], cfg, dist)
        inside = (local >= 0) & (local < table.shape[0])
        x = F.embedding(torch.where(inside, local, 0), table)
        x = dist.comm.psum(torch.where(inside[..., None], x, 0), dist.tp)
    if cfg.emb_scale != 1.0:
        x = mul_scalar(x, cfg.emb_scale)
    return x


def lm_logits(x, p, cfg, dist=None, gather=True):
    """x @ the head (the tied table's transpose, or ``lm_head``).  On a
    mesh whose rule split the vocab over `model`, this rank's columns,
    all-gathered over `model` unless ``gather`` is false (the loss takes
    them split: ``next_token_loss``)."""
    if cfg.logit_scale != 1.0:
        x = mul_scalar(x, cfg.logit_scale)
    w = p["tokens"].T if cfg.tie_embeddings else p["lm_head"]
    if not _vocab_split(w.shape[-1], cfg, dist):
        return x @ w
    logits = dist.comm.enter(x, dist.tp) @ w
    if not gather:
        return logits
    return dist.comm.all_gather(logits, dist.tp, dim=-1)


def next_token_loss(logits, labels, mask, cfg, dist=None):
    """The reference's ``next_token_loss``: the mean cross entropy over
    the batch (over the tokens ``mask`` keeps, where given).  On a mesh,
    ``logits`` and ``labels`` are this rank's rows, and the mean is the
    global batch's: psum of the (masked) sum over the batch axes, divided
    by the psum of the (mask's) count, not a mean of the ranks' means.  A
    vocab split over `model` stays split, as the reference never gathers
    it: the local max (a pmax, no gradient), the psum of the local sums
    of exponentials, and the label's logit from the rank whose columns
    hold it (a psum)."""
    if dist is None or not dist.active:
        return L.softmax_xent(logits, labels, mask)
    comm, lf = dist.comm, logits.float()
    labels = labels.long()
    if _vocab_split(lf.shape[-1], cfg, dist):
        m = comm.pmax(lf.amax(dim=-1), dist.tp)
        lse = m + torch.log(comm.psum(
            torch.exp(lf - m[..., None]).sum(dim=-1), dist.tp))
        local = labels - _vocab0(lf.shape[-1], cfg, dist)
        inside = (local >= 0) & (local < lf.shape[-1])
        ll = torch.gather(lf, -1, torch.where(inside, local, 0)[..., None])
        ll = comm.psum(torch.where(inside, ll[..., 0], 0.0), dist.tp)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return comm.psum((nll * mask).sum(), dist.dp) / torch.clamp(
            comm.psum(mask.sum(), dist.dp), min=1.0)
    return comm.psum(nll.sum(), dist.dp) / (nll.numel() * dist.dp_size)


def col_product(x, w, width, dist):
    """x @ w for a w whose ``width`` columns may be split over `model`
    (MLA's down-projections, the MTP projection): x enters the split
    product and its columns are all-gathered, the whole width on every
    rank."""
    if w.shape[-1] == width:
        return x @ w
    y = dist.comm.enter(x, dist.tp) @ w
    return dist.comm.all_gather(y, dist.tp, dim=-1)


def row_sum(y, rows, full_rows, dist):
    """y = x @ w where w holds ``rows`` of its ``full_rows`` input rows:
    a row-split w's partial products summed over ``dist.tp`` (Megatron's
    one all-reduce a block), else y."""
    if rows == full_rows or not dist.active:
        return y
    return dist.comm.psum(y, dist.tp)


def mlp(x, p, cfg, dist):
    """The dense MLP (``layers.apply_mlp``); on a mesh whose rule split it
    over `model`, ``gate``/``up`` hold the rank's columns and ``down``
    their rows: x enters the split product and the partial sums are
    summed over `model` (``row_sum``)."""
    rows = p["down"].shape[-2]
    x = enter_split(x, rows < cfg.d_ff, dist)
    return row_sum(L.apply_mlp(x, p, cfg.act), rows, cfg.d_ff, dist)


def local_block(t, n_local, dist):
    """The rank's ``n_local`` entries of the last dim of a leaf every rank
    holds whole, for a computation split over `model` by channels (RWKV's
    ``w0``, ``u`` and ``ln_scale`` at the rank's heads, Mamba's
    ``conv_b``, ``dt_bias`` and ``D`` at its channels): the block at the
    rank's `model` index, ``t`` entering the split (its gradient psum'd
    over `model`).  ``t`` itself where it holds ``n_local``."""
    if t.shape[-1] == n_local:
        return t
    c0 = dist.comm.axis_index(dist.tp) * n_local
    return dist.comm.enter(t, dist.tp)[..., c0:c0 + n_local]


def enter_split(x, split, dist):
    """``x`` marked as entering a computation split over `model` where
    ``split`` (``collectives.py``: its gradient is psum'd there)."""
    return dist.comm.enter(x, dist.tp) if split else x


def residual_scale(cfg) -> float:
    """depth_scale / sqrt(L), computed in f32 like the reference."""
    if cfg.depth_scale:
        return float(np.float32(cfg.depth_scale)
                     / np.sqrt(np.float32(cfg.n_layers)))
    return 1.0


# ---------------------------------------------------------------------------
# per-layer params stacked on a leading (L, ...) dim, as the reference's
# vmapped init and lax.scan over layers keep them


def index_layer(tree, l):
    """Layer ``l``'s params as views of the stacked tensors."""
    return {k: index_layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def unstack_layers(tree, n):
    """Every layer's params as views of the stacked tensors, a list of
    ``n`` trees.  One ``unbind`` per leaf: its backward stacks the
    layers' gradients into the stacked leaf once, where ``index_layer``'s
    views would each add a zero-filled copy of the whole leaf."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = unstack_layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for l in range(n):
            out[l][k] = parts[l]
    return out
