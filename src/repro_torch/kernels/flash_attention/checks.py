"""What the backward kernel's checks must be able to see: the plain
gradient (``ref.attention_bwd_ref``'s formula) with one fault a kernel
could make, for ``chip_smoke.py`` and the tests to hold against the
limits.

* "no-delta": dS = P dP, the D = rowsum(dO * o) term dropped;
* "no-softcap-derivative": the factor 1 - tanh^2(s / c) dropped;
* "skip-last-tile" / "skip-first-tile": for every 64-row q tile, the
  last (the causal diagonal's) or the first (the window's edge) of the
  64-row kv tiles the forward visits skipped in every product, as a tile
  loop one tile short would;
* "lse-neighbour-row": P = exp(S - LSE) with each row's LSE taken from
  the next row (the last row from the first), as an off-by-one in the
  forward's LSE store or the backward's read would give;
* "lse-log2": the LSE in log2 units read as natural ones, P = exp(S -
  LSE log2 e), as a forward that stored m + log2 l without dividing by
  log2 e would give;
* "stale-q-stage": in dK and dV, every q tile of the Hopper dK/dV ring
  (``kernel_bwd.HOPPER_RING_ROWS``) but the first read with the Q, dO,
  LSE and D of the tile before it (masks still by its own rows), as a
  ring stage waited on with a stale phase would hold;
* "dkdv-past-128-dropped": dK's and dV's columns from 128 on zero (hd >
  128), as a backward whose warps owned the first 128 columns of a row
  alone (the design up to hd 128) would leave them unwritten.

And what the forward's checks must be able to see at a head dim that is
no multiple of the Hopper forward's 64-column TMA box (hd 120), or that
takes three boxes a row (MLA's q·k 192) or four (gemma3's 256), as
inputs on which the plain forward returns what the faulty kernel would
(``forward_fault_inputs``, ``FWD_FAULTS``):

* "pad-from-next-head": the padding columns hd..127 of q and k read from
  head h + 1's first columns (zeros for the last head), as a tensor map
  with {hd, h} flattened into one dimension would give;
* "second-box-dropped": columns 64..hd-1 of q, k and v zero, as a
  producer that loaded hd // 64 boxes a row (not the ceiling) would
  leave them;
* "third-box-dropped": columns 128..hd-1 of q and k zero (hd > 128), as
  a producer that loaded two boxes of each q and k row (v's count) would
  leave them;
* "fourth-box-dropped": columns 192..255 of q, k and v zero (hd 256), as
  a producer that loaded three boxes a row (MLA's q·k count) would leave
  them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.kernel_bwd import HOPPER_RING_ROWS
from repro_torch.kernels.flash_attention.ref import attention_lse, scores

FAULTS = ("no-delta", "no-softcap-derivative", "skip-last-tile",
          "skip-first-tile", "lse-neighbour-row", "lse-log2",
          "stale-q-stage", "dkdv-past-128-dropped")
TILE = 64    # the kernel's q and kv tile rows
FWD_FAULTS = ("pad-from-next-head", "second-box-dropped",
              "third-box-dropped", "fourth-box-dropped")
BOX = 64     # columns of the Hopper forward's TMA box


def visited_tiles(sq, skv, causal, window, device=None):
    """(begin, end) of the kv tiles each q row's tile visits (the
    kernel's ``kv_tile_range``), as (sq,) tensors."""
    q0 = torch.arange(sq, device=device) // TILE * TILE
    q_last = torch.clamp(q0 + TILE, max=sq) - 1
    end = torch.full_like(q0, -(-skv // TILE))
    if causal:
        end = torch.minimum(end, q_last // TILE + 1)
    begin = torch.zeros_like(q0)
    if window:
        begin = torch.clamp(q0 - window + 1, min=0) // TILE
    return begin, end


def attention_bwd_faulty(q, k, v, o, do, fault, *, causal=True, window=0,
                         softcap=0.0):
    """(dq, dk, dv) of ``attention_bwd_ref`` with ``fault``, in f32."""
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}; one of {FAULTS}")
    scale = 1.0 / math.sqrt(q.shape[3])
    kw = dict(causal=causal, window=window, softcap=softcap)
    if fault == "dkdv-past-128-dropped":
        if q.shape[3] <= 128:
            raise ValueError(f"hd {q.shape[3]} has no columns past 128: "
                             f"{fault} cannot happen")
        dq, dk, dv = _grads(q, k, v, o, do, scale, kw,
                            attention_lse(q, k, **kw)[..., None])
        dk[..., 128:] = 0
        dv[..., 128:] = 0
        return dq, dk, dv
    lse = None
    if fault in ("lse-neighbour-row", "lse-log2", "stale-q-stage"):
        lse = attention_lse(q, k, **kw)[..., None]           # (b, h, sq, 1)
    if fault == "lse-neighbour-row":
        return _grads(q, k, v, o, do, scale, kw, torch.roll(lse, -1, dims=2))
    if fault == "lse-log2":
        return _grads(q, k, v, o, do, scale, kw, lse * math.log2(math.e))
    if fault == "stale-q-stage":
        ring = HOPPER_RING_ROWS["dkdv"].get(q.shape[3], TILE)
        src = torch.arange(q.shape[1], device=q.device)
        src = torch.where(src >= ring, src - ring, src)   # the tile before
        _, dk, dv = _grads(q[:, src], k, v, o[:, src], do[:, src], scale, kw,
                           lse[..., src, :])
        return _grads(q, k, v, o, do, scale, kw, lse)[0], dk, dv
    s, t = scores(q, k, **kw)
    p = torch.softmax(s, dim=-1)
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    d = (dof * o.float()).sum(dim=-1).transpose(1, 2)[..., None]
    ds = p * dp if fault == "no-delta" else p * (dp - d)
    if t is not None and fault != "no-softcap-derivative":
        ds = ds * (1 - t * t)
    if fault in ("skip-last-tile", "skip-first-tile"):
        begin, end = visited_tiles(q.shape[1], k.shape[1], causal, window,
                                   q.device)
        lost = end - 1 if fault == "skip-last-tile" else begin
        k_tile = torch.arange(k.shape[1], device=q.device) // TILE
        keep = k_tile[None, :] != lost[:, None]              # (sq, skv)
        p, ds = p * keep, ds * keep
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq, dk, dv


def _grads(q, k, v, o, do, scale, kw, lse):
    """attention_bwd_ref's formula in f32 with P = exp(S - lse), lse (b,
    h, sq, 1) as the Hopper backward reads it."""
    s, t = scores(q, k, **kw)
    p = torch.exp(s - lse)
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    d = (dof * o.float()).sum(dim=-1).transpose(1, 2)[..., None]
    ds = p * (dp - d)
    if t is not None:
        ds = ds * (1 - t * t)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq, dk, dv


def bwd_row_scales(q, k, v, o, do, *, causal=True, window=0, softcap=0.0):
    """Per-row scale of each gradient: the norm of the sum of magnitudes
    that makes the row, which bounds its rounding error where the value
    itself does not (dS = P (dP - D) cancels as a row's softmax nears one
    key).  dq_i: scale sum_j P_ij (|dP_ij| + |D_i|) c_ij |k_j|, with c the
    softcap factor; dk_j the same over i with |q_i|; dv_j: sum_i P_ij
    |dO_i|.  Each is at least the row's own norm.  Returns three (b, s,
    h) tensors, in f32."""
    scale = 1.0 / math.sqrt(q.shape[3])
    s, t = scores(q, k, causal=causal, window=window, softcap=softcap)
    p = torch.softmax(s, dim=-1)
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float()).abs_()
    d = (dof * o.float()).sum(dim=-1).transpose(1, 2)[..., None].abs()
    m = p * (dp + d)
    if t is not None:
        m = m * (1 - t * t)
    mq = torch.einsum("bhqk,bkhd->bqhd", m, k.float().abs()) * scale
    mk = torch.einsum("bhqk,bqhd->bkhd", m, q.float().abs()) * scale
    mv = torch.einsum("bhqk,bqhd->bkhd", p, dof.abs())
    return tuple(x.norm(dim=-1) for x in (mq, mk, mv))


def grad_row_err(out, ref, row_scale):
    """Worst ||out - ref|| / row scale over the (b, s, h) rows of one
    gradient (``bwd_row_scales``)."""
    err = (out.float() - ref.float()).norm(dim=-1)
    return (err / row_scale.clamp_min(1e-30)).max().item()


def forward_fault_inputs(q, k, v, fault):
    """f32 (q, k, v) on which a plain forward (``ref.attention_ref``, or
    ``sliding_window_attention``, each scaling by 1/sqrt of its inputs'
    last dim) returns, in its first hd columns, what the Hopper forward
    would return with ``fault`` (``FWD_FAULTS``).  For
    "pad-from-next-head" they are HDP = 128 columns wide, q scaled by
    sqrt(HDP / hd) so that the plain version's 1/sqrt(HDP) is the
    kernel's 1/sqrt(hd), and v padded with zeros (the kernel's O columns
    past hd are never stored)."""
    if fault not in FWD_FAULTS:
        raise ValueError(f"no forward fault {fault!r}; one of {FWD_FAULTS}")
    hd = q.shape[3]
    hdp = -(-hd // BOX) * BOX
    q, k, v = (t.float() for t in (q, k, v))
    if fault == "fourth-box-dropped":
        if hd <= 3 * BOX:
            raise ValueError(f"hd {hd} takes at most three boxes: {fault} "
                             f"cannot happen")
        q, k, v = (t.clone() for t in (q, k, v))
        for t in (q, k, v):
            t[..., 3 * BOX:] = 0
        return q, k, v
    if fault == "third-box-dropped":
        if hd <= 2 * BOX:
            raise ValueError(f"hd {hd} takes at most two boxes: {fault} "
                             f"cannot happen")
        q, k = q.clone(), k.clone()
        q[..., 2 * BOX:] = 0
        k[..., 2 * BOX:] = 0
        return q, k, v
    if hdp == hd:
        raise ValueError(f"hd {hd} fills whole boxes: {fault} cannot happen")
    if fault == "second-box-dropped":
        q, k, v = (t.clone() for t in (q, k, v))
        for t in (q, k, v):
            t[..., BOX:] = 0
        return q, k, v

    def pad(t):
        nxt = torch.zeros_like(t[..., :hdp - hd])
        nxt[:, :, :-1] = t[:, :, 1:, :hdp - hd]
        return torch.cat([t, nxt], dim=-1)

    return (pad(q) * math.sqrt(hdp / hd), pad(k),
            torch.nn.functional.pad(v, (0, hdp - hd)))
