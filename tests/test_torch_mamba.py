"""The PyTorch port's Mamba and Jamba on the CPU against the JAX package.

The port's plain selective scan (the version its dispatcher takes for CPU
tensors, and the one the CUDA kernel is held against on the card) against
the reference Pallas kernel in interpret mode and the reference oracle,
at the reference kernel tests' tolerances; the one-token step; the Mamba
mixer with bridged weights, with and without a carried state; ``JambaLM``
prefill and decode logits and cache for the smoke config and for the
structure of the 4-layer cut that ``chip_smoke.py`` serves (layers 4-7 of
a published period: attention + MLP, Mamba + MoE, Mamba + MLP, Mamba +
MoE); a mirror of the decode-vs-prefill checks; and the dispatcher's
rules.  Inputs come from numpy seeds.  The CUDA kernel itself runs only
on the card (``chip_smoke.py``, ``tests/test_torch_gpu.py``)."""
from __future__ import annotations

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.kernels.mamba_scan import ops as jops  # noqa: E402
from repro.kernels.mamba_scan.kernel import selective_scan_pallas  # noqa: E402
from repro.kernels.mamba_scan.ref import selective_scan_ref as jax_ref  # noqa: E402
from repro.models import mamba as jMB  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as tK  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as tops  # noqa: E402
from repro_torch.models import mamba as tMB  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402
from repro_torch.models.hybrid import JambaLM  # noqa: E402

ARCH = "jamba-1.5-large-398b"
# the cut chip_smoke.py serves, at smoke widths
CUT = dict(n_layers=4, attn_layer_period=4, attn_layer_offset=0)
# the reference kernel tests' tolerances (tests/test_kernels.py)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **tol)


def scan_inputs(b, s, di, N, dtype="float32", seed=0):
    """The reference kernel tests' distribution: x, B, C, D and the state
    uniform(-1, 1), dt = softplus(uniform) * 0.1, A = -exp(uniform(0,
    1)); x, dt, B and C in ``dtype``, A, D and the state in f32.  Returns
    (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)

    def uni(*shape, lo=-1.0):
        return rng.uniform(lo, 1, shape).astype(np.float32)

    x = uni(b, s, di)
    dt = (np.log1p(np.exp(uni(b, s, di))) * 0.1).astype(np.float32)
    A = -np.exp(uni(di, N, lo=0.0))
    B, C = uni(b, s, N), uni(b, s, N)
    D, h0 = uni(di), uni(b, di, N)
    dts = [dtype, dtype, "float32", dtype, dtype, "float32", "float32"]
    arrs = (x, dt, A, B, C, D, h0)
    return ([jnp.asarray(a).astype(JDT[d]) for a, d in zip(arrs, dts)],
            [torch.from_numpy(a).to(TDT[d]) for a, d in zip(arrs, dts)])


# ------------------------------------------------------------ the kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,N,chunk,bd", [
    (2, 40, 24, 8, 16, 16), (1, 100, 64, 16, 32, 32),
    (2, 33, 48, 4, 16, 48),
])
def test_plain_matches_pallas_kernel(b, s, di, N, chunk, bd, dtype):
    """The reference's own cases, ragged s included (padded time in the
    Pallas kernel, exactly s steps here)."""
    jin, tin = scan_inputs(b, s, di, N, dtype)
    y1, h1 = selective_scan_pallas(*jin, chunk=chunk, block_d=bd,
                                   interpret=True)
    y, h = tops.selective_scan(*tin)
    assert y.dtype == TDT[dtype] and y.shape == (b, s, di)
    assert h.dtype == torch.float32 and h.shape == (b, di, N)
    close(y1, y, TOL[dtype])
    close(h1, h, STATE_TOL)
    y2, h2 = jax_ref(*jin)
    close(y2, y, TOL[dtype])
    close(h2, h, TOL["float32"] if dtype == "float32" else STATE_TOL)


@pytest.mark.parametrize("s", [2, 37])
def test_plain_matches_oracle_on_strided_views(s):
    """B and C as column slices of one (b, s, r + 2N) projection, as the
    Mamba layer hands them over."""
    b, di, N, r = 2, 16, 8, 5
    jin, tin = scan_inputs(b, s, di, N, seed=7)
    proj = np.random.default_rng(8).uniform(
        -1, 1, (b, s, r + 2 * N)).astype(np.float32)
    tproj = torch.from_numpy(proj)
    tB, tC = tproj[..., r:r + N], tproj[..., r + N:]
    assert not tB.is_contiguous()
    x, dt, A, _, _, D, h0 = tin
    y, h = tops.selective_scan(x, dt, A, tB, tC, D, h0)
    jx, jdt, jA, _, _, jD, jh0 = jin
    y2, h2 = jax_ref(jx, jdt, jA, jnp.asarray(proj[..., r:r + N]),
                     jnp.asarray(proj[..., r + N:]), jD, jh0)
    close(y2, y, TOL["float32"])
    close(h2, h, TOL["float32"])


def test_step_matches_reference_step_and_scan():
    """The one-token decode step equals the reference's step and one step
    of the scan."""
    jin, tin = scan_inputs(2, 1, 16, 8, seed=3)
    x, dt, A, B, C, D, h0 = tin
    y, h = tops.selective_scan_step(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                                    D, h0)
    jx, jdt, jA, jB, jC, jD, jh0 = jin
    y1, h1 = jops.selective_scan_step(jx[:, 0], jdt[:, 0], jA, jB[:, 0],
                                      jC[:, 0], jD, jh0)
    close(y1, y, TOL["float32"])
    close(h1, h, TOL["float32"])
    y2, h2 = jax_ref(*jin)
    close(y2[:, 0], y, TOL["float32"])
    close(h2, h, TOL["float32"])


# -------------------------------------------------------- the dispatcher


def test_dispatch_counts_no_cpu_launches():
    _, tin = scan_inputs(1, 8, 16, 4)
    before = tops.launches
    tops.selective_scan(*tin)
    assert tops.launches == before


def test_dispatch_rejects_bad_input():
    _, (x, dt, A, B, C, D, h0) = scan_inputs(1, 8, 16, 4)
    with pytest.raises(ValueError, match=r"x, dt \(b,s,di\)"):
        tops.selective_scan(x, dt[:, :4], A, B, C, D, h0)
    with pytest.raises(ValueError, match="expected A"):
        tops.selective_scan(x, dt, A[:8], B, C, D, h0)
    with pytest.raises(ValueError, match="expected A"):
        tops.selective_scan(x, dt, A, B[..., :2], C, D, h0)
    with pytest.raises(ValueError, match="expected A"):
        tops.selective_scan(x, dt, A, B, C, D, h0[:, :, :2])
    with pytest.raises(ValueError, match="empty"):
        tops.selective_scan(x[:, :0], dt[:, :0], A, B[:, :0], C[:, :0], D,
                            h0)
    with pytest.raises(TypeError, match="floating"):
        tops.selective_scan(x.long(), dt, A, B, C, D, h0)
    before = tops.launches
    meta = [t.to("meta") for t in (x, dt, A, B, C, D, h0)]
    with pytest.raises(ValueError, match="different devices"):
        tops.selective_scan(*meta[:6], h0)
    with pytest.raises(ValueError, match="no selective_scan for device meta"):
        tops.selective_scan(*meta)
    assert tops.launches == before


def test_cpu_grad_takes_plain_version():
    _, (x, dt, A, B, C, D, h0) = scan_inputs(1, 6, 8, 4)
    x.requires_grad_(True)
    y, h = tops.selective_scan(x, dt, A, B, C, D, h0)
    (y.sum() + h.sum()).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_build_is_keyed_by_source_and_lazy():
    digest = hashlib.sha256(tK.SOURCE.read_bytes()).hexdigest()[:16]
    assert tK.library_path() == (_build.BUILD_ROOT
                                 / f"selective_scan-{digest}"
                                 / "libselective_scan.so")
    assert tK.library.cache_info().currsize == 0
    assert tK.SOURCE.name == "selective_scan.cu" and tK.SOURCE.exists()


# ------------------------------------------------------------ the mixer


def perturbed(params, seed):
    """The reference init leaves conv_b at 0, dt_bias at -4, A_log at
    log(1..N), D at 1 and the norm scales at 1: add noise to them,
    identically for both packages, so their paths are checked."""
    rng = np.random.default_rng(seed)
    noisy = {"conv_b": 0.3, "dt_bias": 0.5, "A_log": 0.3, "D": 0.5,
             "scale": 0.2}

    def fn(path, leaf):
        scale = noisy.get(path[-1].key)
        if scale is None:
            return leaf
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * scale
        return (leaf.astype(jnp.float32) + noise).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fn, params)


def bridged(tree):
    return params_from_flat({k: np.asarray(v) for k, v in _flatten(tree)})


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("s", [1, 2, 9])
def test_apply_mamba_matches_reference(s, carried):
    """s = 1 takes the step path, s = 2 is shorter than the conv's K - 1
    = 3 rows of state, s = 9 longer."""
    cfg = get_smoke(ARCH).replace(dtype="float32")
    tcfg = torch_smoke(ARCH).replace(dtype="float32")
    jp = perturbed(jMB.init_mamba(jax.random.PRNGKey(4), cfg, jnp.float32),
                   5)
    tp = bridged(jp)
    b, d = 2, cfg.d_model
    di, N, K = 2 * d, cfg.mamba.d_state, cfg.mamba.d_conv
    g = np.random.default_rng(6)
    x = g.standard_normal((b, s, d)).astype(np.float32)
    jst = tst = None
    if carried:
        ssm = g.standard_normal((b, di, N)).astype(np.float32)
        conv = g.standard_normal((b, K - 1, di)).astype(np.float32)
        jst = {"ssm": jnp.asarray(ssm), "conv": jnp.asarray(conv)}
        tst = {"ssm": torch.from_numpy(ssm), "conv": torch.from_numpy(conv)}
    jy, jnew = jMB.apply_mamba(jnp.asarray(x), jp, cfg, jst)
    before = tops.launches
    ty, tnew = tMB.apply_mamba(torch.from_numpy(x), tp, tcfg, tst)
    assert tops.launches == before
    close(jy, ty, TOL["float32"])
    close(jnew["ssm"], tnew["ssm"], TOL["float32"])
    close(jnew["conv"], tnew["conv"], TOL["float32"])


def test_apply_mamba_bf16_keeps_the_reference_dtypes():
    """bf16 model: dt and the ssm state are f32, the conv state bf16."""
    cfg = get_smoke(ARCH)
    jp = perturbed(jMB.init_mamba(jax.random.PRNGKey(7), cfg,
                                  jnp.bfloat16), 8)
    tp = bridged(jp)
    assert tp["A_log"].dtype == torch.float32
    assert tp["D"].dtype == torch.float32
    assert tp["in_proj"].dtype == torch.bfloat16
    x = np.random.default_rng(9).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    jy, jnew = jMB.apply_mamba(jnp.asarray(x).astype(jnp.bfloat16), jp, cfg)
    ty, tnew = tMB.apply_mamba(torch.from_numpy(x).bfloat16(), tp,
                               torch_smoke(ARCH))
    assert ty.dtype == torch.bfloat16
    assert tnew["ssm"].dtype == torch.float32
    assert tnew["conv"].dtype == torch.bfloat16
    close(jy, ty, TOL["bfloat16"])
    close(jnew["ssm"], tnew["ssm"], TOL["bfloat16"])
    close(jnew["conv"], tnew["conv"], TOL["bfloat16"])


# --------------------------------------------------------------- JambaLM


def model_pair(dtype="float32", seed=0, **replace):
    jm = jax_build(get_smoke(ARCH).replace(dtype=dtype, **replace))
    jp = perturbed(jm.init(jax.random.PRNGKey(seed)), seed + 10)
    tm = torch_build(torch_smoke(ARCH).replace(dtype=dtype, **replace))
    assert isinstance(tm, JambaLM)
    assert (tm.moe_js, tm.mlp_js, tm.n_mamba) == (jm.moe_js, jm.mlp_js,
                                                  jm.n_mamba)
    return jm, jp, tm, bridged(jp)


def close_cache(jcache, tcache, tol):
    for path, leaf in _flatten(jcache):
        node = tcache
        for key in path.split("/"):
            node = node[key]
        close(leaf, node, tol)


@pytest.mark.parametrize("replace", [{}, CUT], ids=["smoke", "cut"])
def test_prefill_decode_match_reference(replace):
    """Logits and the whole cache (attention k/v, Mamba ssm and conv
    states) after prefill and after each of three decode steps, f32 at
    2e-5."""
    jm, jp, tm, tp = model_pair(**replace)
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jcache, jlen = jax.jit(lambda p, t: jm.prefill(p, t, 28))(
        jp, jnp.asarray(toks))
    before = tops.launches
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 28)
    assert tops.launches == before                # the CPU: plain scan
    assert tl.shape == (2, 1, jm.cfg.vocab_size) and tlen == int(jlen) == 20
    close(jl, tl, TOL["float32"])
    close_cache(jcache, tcache, TOL["float32"])
    step = jax.jit(jm.decode)
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for _ in range(3):
        jl, jcache, jlen = step(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            ssm = tcache["mamba"]["ssm"]
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
            assert tcache["mamba"]["ssm"] is ssm     # updated in place
        assert tlen == int(jlen)
        close(jl, tl, TOL["float32"])
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    close_cache(jcache, tcache, TOL["float32"])


def test_decode_past_max_len_matches_reference():
    """An 8-token prompt into a cache of max_len 8, then two decode steps
    past its end: the attention layer's writes clamp to the last slot as
    the reference's dynamic_update_slice does; logits, lengths and the
    whole cache match, f32 at 2e-5."""
    jm, jp, tm, tp = model_pair(seed=3)
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jcache, jlen = jm.prefill(jp, jnp.asarray(toks), 8)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 8)
    close(jl, tl, TOL["float32"])
    nxt = np.array([[3], [11]], np.int32)
    for want in (9, 10):
        jl, jcache, jlen = jm.decode(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
        assert tlen == int(jlen) == want
        assert torch.isfinite(tl).all()
        close(jl, tl, TOL["float32"])
        nxt = nxt + 1
    close_cache(jcache, tcache, TOL["float32"])


def test_one_token_prompt_takes_the_step_path():
    jm, jp, tm, tp = model_pair(seed=2, **CUT)
    toks = np.array([[5], [9]], np.int32)
    jl, jcache, _ = jm.prefill(jp, jnp.asarray(toks), 4)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 4)
    assert tlen == 1
    close(jl, tl, TOL["float32"])
    close_cache(jcache, tcache, TOL["float32"])


def test_bf16_prefill_matches_reference():
    jm, jp, tm, tp = model_pair("bfloat16", seed=3, **CUT)
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _, _ = jm.prefill(jp, jnp.asarray(toks), 16)
    with torch.inference_mode():
        tl, _, _ = tm.prefill(tp, torch.from_numpy(toks), 16)
    assert tl.dtype == torch.bfloat16
    close(jl, tl, TOL["bfloat16"])


def full_logits(model, params, toks):
    """Logits at every position from one cache-free forward."""
    from repro_torch.models import common as tC
    from repro_torch.models import layers as tL
    x = tC.embed(toks, params["embed"], model.cfg)
    pos = torch.arange(x.shape[1])[None, :]
    x = model._run_layers(x, params, pos, None, None, "train")
    x = tL.apply_norm(x, params["final_norm"], model.cfg)
    return tC.lm_logits(x, params["embed"], model.cfg)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2),
                                       ("float32", 1e-4)])
def test_decode_matches_prefill_jamba(dtype, tol):
    """Torch mirror of the reference's decode-vs-prefill checks:
    teacher-forced decode (the attention cache and the Mamba states)
    reproduces the logits of one cache-free forward (bf16 at the
    reference's 2e-2).  Capacity factor 16, so that neither side drops a
    token (a forward of 12 tokens and a decode step of one fill the
    experts differently)."""
    cfg = torch_smoke(ARCH).replace(dtype=dtype, **CUT)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    tm = torch_build(cfg)
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 12)))
    with torch.inference_mode():
        ref = full_logits(tm, tp, toks).float()
        logits, cache, length = tm.prefill(tp, toks[:, :6], 16)
        torch.testing.assert_close(logits[:, 0].float(), ref[:, 5],
                                   rtol=tol, atol=tol)
        for i in range(6, 11):
            logits, cache, length = tm.decode(tp, cache, toks[:, i:i + 1],
                                              length)
            torch.testing.assert_close(logits[:, 0].float(), ref[:, i],
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("replace", [{}, CUT], ids=["smoke", "cut"])
def test_init_and_cache_layout_match_reference(replace):
    """Seeded initialisers: the same names, shapes and dtypes as the
    reference's, and the cache layout of ``init_cache``."""
    jm = jax_build(get_smoke(ARCH).replace(**replace))
    tm = torch_build(torch_smoke(ARCH).replace(**replace))
    jflat = dict(_flatten(jax.eval_shape(jm.init, jax.random.PRNGKey(0))))
    tflat = dict(_flatten_torch(tm.init(torch.Generator().manual_seed(0),
                                        "cpu")))
    assert sorted(jflat) == sorted(tflat)
    for key, leaf in jflat.items():
        assert tuple(leaf.shape) == tuple(tflat[key].shape), key
        assert str(leaf.dtype) == str(tflat[key].dtype)[6:], key
    jcache = dict(_flatten(jm.init_cache(3, 10)))
    tcache = dict(_flatten_torch(tm.init_cache(3, 10, "cpu")))
    assert sorted(jcache) == sorted(tcache)
    for key, leaf in jcache.items():
        assert tuple(leaf.shape) == tuple(tcache[key].shape), key
        assert str(leaf.dtype) == str(tcache[key].dtype)[6:], key


def _flatten_torch(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten_torch(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_long_context_windows_the_attention_layer():
    """``long_context`` passes the config's window to the attention
    layer, as the reference does."""
    jm = jax_build(get_smoke(ARCH).replace(dtype="float32"),
                   long_context=True)
    jp = jm.init(jax.random.PRNGKey(5))
    tm = torch_build(torch_smoke(ARCH).replace(dtype="float32"),
                     long_context=True)
    assert tm.attn_window == jm.attn_window == 16
    toks = np.random.default_rng(6).integers(
        0, jm.cfg.vocab_size, (1, 30)).astype(np.int32)
    jl, _, _ = jm.prefill(jp, jnp.asarray(toks), 32)
    with torch.inference_mode():
        tl, _, _ = tm.prefill(bridged(jp), torch.from_numpy(toks), 32)
    close(jl, tl, TOL["float32"])


def test_loss_raises_naming_the_training_item():
    tm = torch_build(torch_smoke(ARCH))
    with pytest.raises(NotImplementedError, match="item 6"):
        tm.loss({}, {})
