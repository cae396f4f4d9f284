"""Mamba (selective SSM) mixer layer: the port of ``repro.models.mamba``.

Prefill runs the selective scan's dispatcher (kernel K3 on the card);
a one-token call, decode or a one-token prompt, takes the plain one-step
path, as in the reference.  What the reference does, kept here:
  * the depthwise causal conv is a sum of shifted slices in the model
    dtype, in order i = 0..K-1, then ``+ b`` (``F.conv1d`` would sum in
    f32 and round once, and on the card run in TF32 under cuDNN);
  * the new conv state is the last K-1 rows of ``concat(state, x)``;
  * ``dt`` is f32 in a bf16 model: the bf16 ``dt_proj`` product is
    promoted by the f32 ``dt_bias`` before the softplus; ``A_log`` and
    ``D`` are f32 parameters;
  * softplus: ``jax.nn.softplus`` has no threshold and ``F.softplus``
    returns x above 20, equal within 2e-9 there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import layers as L


def _dims(cfg):
    m = cfg.mamba
    di = m.expand * cfg.d_model
    dtr = m.dt_rank or cfg.d_model // 16
    return m, di, dtr


def init_mamba(generator, cfg, dtype, device, lead=()):
    m, di, dtr = _dims(cfg)
    d, N = cfg.d_model, m.d_state
    kw = dict(lead=lead)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": L.dense_init(generator, (d, 2 * di), dtype, device, **kw),
        "conv_w": L.dense_init(generator, (m.d_conv, di), dtype, device,
                               fan_in=m.d_conv, **kw),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=device),
        "x_proj": L.dense_init(generator, (di, dtr + 2 * N), dtype, device,
                               **kw),
        "dt_proj": L.dense_init(generator, (dtr, di), dtype, device,
                                fan_in=dtr, **kw),
        # softplus(-4) ~ 0.018
        "dt_bias": torch.full((*lead, di), -4.0, dtype=dtype, device=device),
        "A_log": a_log.expand(*lead, di, N).clone(),
        "D": torch.ones((*lead, di), dtype=torch.float32, device=device),
        "out_proj": L.dense_init(generator, (di, d), dtype, device, **kw),
    }


def _causal_conv(x, w, b, conv_state):
    """x (b, s, di); w (K, di) depthwise; conv_state (b, K-1, di).
    Returns y, new conv state (b, K-1, di)."""
    K, s = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state, x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, xp.shape[1] - (K - 1):] if K > 1 else conv_state
    return y + b, new_state


def apply_mamba(x, p, cfg, state=None):
    """x (b, s, d).  state = {'ssm': (b, di, N) f32, 'conv': (b, K-1, di)}
    or None (zeros).  Returns y (b, s, d), new state (fresh tensors; the
    caller copies them where it keeps the state)."""
    m, di, dtr = _dims(cfg)
    b, s, _ = x.shape
    if state is None:
        state = init_state(cfg, b, x.device)
    xz = x @ p["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"],
                                  state["conv"])
    xc = L.silu(xc)
    proj = xc @ p["x_proj"]
    dt = F.softplus(proj[..., :dtr] @ p["dt_proj"] + p["dt_bias"].float())
    B = proj[..., dtr:dtr + m.d_state]
    C = proj[..., dtr + m.d_state:]
    A = -torch.exp(p["A_log"])
    if s == 1:
        y, ssm = scan_ops.selective_scan_step(
            xc[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], p["D"], state["ssm"])
        y = y[:, None]
    else:
        y, ssm = scan_ops.selective_scan(xc, dt, A, B, C, p["D"],
                                         state["ssm"])
    y = y * L.silu(z)
    return y @ p["out_proj"], {"ssm": ssm, "conv": conv_state}


def init_state(cfg, batch, device):
    m, di, _ = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, m.d_conv - 1, di),
                            dtype=(torch.bfloat16 if cfg.dtype == "bfloat16"
                                   else torch.float32), device=device),
    }
