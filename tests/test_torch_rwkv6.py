"""The PyTorch port's RWKV6 on the CPU against the JAX package.

The port's plain WKV6 (the version its dispatcher takes for CPU tensors,
and the one the CUDA kernel is held against on the card) against the
reference Pallas kernel in interpret mode and the reference oracle, at
the reference kernel tests' tolerances; the one-token step; time mix and
channel mix with bridged weights; ``RWKVLM`` prefill and decode logits
and state; and the dispatcher's and the build's rules.  Inputs come from
numpy seeds.  The CUDA kernel itself runs only on the card
(``chip_smoke.py``, ``tests/test_torch_gpu.py``)."""
from __future__ import annotations

import hashlib
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.checkpoint import _flatten  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.kernels.rwkv6 import ops as jops  # noqa: E402
from repro.kernels.rwkv6.kernel import wkv6_pallas  # noqa: E402
from repro.kernels.rwkv6.ref import wkv6_ref as jax_ref  # noqa: E402
from repro.models import rwkv6 as jR  # noqa: E402
from repro.models.factory import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_flat  # noqa: E402
from repro_torch.configs import get_smoke as torch_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fK  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as tK  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as tops  # noqa: E402
from repro_torch.models import rwkv6 as tR  # noqa: E402
from repro_torch.models.factory import build_model as torch_build  # noqa: E402
from repro_torch.models.rwkv_lm import RWKVLM  # noqa: E402

ARCH = "rwkv6-1.6b"
# the reference kernel tests' tolerances (tests/test_kernels.py)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **tol)


def wkv_inputs(b, s, H, hd, dtype="float32", seed=0):
    """The reference kernel tests' distribution: r/k/v/u uniform(-1, 1)
    and w = sigmoid(uniform) * 0.5 + 0.45 in ``dtype``, the state
    uniform(-1, 1) in f32.  Returns (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)

    def uni(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    r, k, v = uni(b, s, H, hd), uni(b, s, H, hd), uni(b, s, H, hd)
    w = (0.5 / (1 + np.exp(-uni(b, s, H, hd))) + 0.45).astype(np.float32)
    u, s0 = uni(H, hd), uni(b, H, hd, hd)
    dts = [dtype] * 5 + ["float32"]
    return ([jnp.asarray(a).astype(JDT[d]) for a, d in zip(
                (r, k, v, w, u, s0), dts)],
            [torch.from_numpy(a).to(TDT[d]) for a, d in zip(
                (r, k, v, w, u, s0), dts)])


# ------------------------------------------------------------ the kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,H,hd,chunk", [
    (2, 40, 2, 16, 16), (1, 100, 3, 32, 32), (2, 64, 1, 64, 64),
])
def test_plain_matches_pallas_kernel(b, s, H, hd, chunk, dtype):
    """The reference's own cases, ragged s included (padded time in the
    Pallas kernel, exactly s steps here)."""
    jin, tin = wkv_inputs(b, s, H, hd, dtype)
    y1, S1 = wkv6_pallas(*jin, chunk=chunk, interpret=True)
    y, S = tops.wkv6(*tin)
    assert y.dtype == TDT[dtype] and y.shape == (b, s, H, hd)
    assert S.dtype == torch.float32 and S.shape == (b, H, hd, hd)
    close(y1, y, TOL[dtype])
    close(S1, S, STATE_TOL)
    y2, S2 = jax_ref(*jin)
    close(y2, y, TOL[dtype])
    close(S2, S, STATE_TOL)


@pytest.mark.parametrize("s", [1, 37])
def test_plain_matches_oracle_on_strided_views(s):
    """r/k/v/w as (b, s, H, hd) views of one (b, s, 4d) projection, the
    way a fused projection would hand them over; a one-step sequence
    included."""
    b, H, hd = 2, 3, 16
    d = H * hd
    rng = np.random.default_rng(7)
    fused = rng.uniform(-1, 1, (b, s, 4 * d)).astype(np.float32)
    fused[..., 3 * d:] = 0.5 / (1 + np.exp(-fused[..., 3 * d:])) + 0.45
    u = rng.uniform(-1, 1, (H, hd)).astype(np.float32)
    s0 = rng.uniform(-1, 1, (b, H, hd, hd)).astype(np.float32)
    tf = torch.from_numpy(fused)
    views = [tf[..., i * d:(i + 1) * d].view(b, s, H, hd) for i in range(4)]
    assert not views[0].is_contiguous()
    y, S = tops.wkv6(*views, torch.from_numpy(u), torch.from_numpy(s0))
    jin = [jnp.asarray(fused[..., i * d:(i + 1) * d].reshape(b, s, H, hd))
           for i in range(4)]
    y2, S2 = jax_ref(*jin, jnp.asarray(u), jnp.asarray(s0))
    close(y2, y, TOL["float32"])
    close(S2, S, TOL["float32"])


def test_step_matches_reference_step_and_scan():
    """The one-token decode step equals the reference's step and one step
    of the scan."""
    jin, tin = wkv_inputs(2, 1, 2, 16, seed=3)
    r, k, v, w, u, s0 = tin
    y, S = tops.wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    jr, jk, jv, jw, ju, js0 = jin
    y1, S1 = jops.wkv6_step(jr[:, 0], jk[:, 0], jv[:, 0], jw[:, 0], ju, js0)
    close(y1, y, TOL["float32"])
    close(S1, S, TOL["float32"])
    y2, S2 = jax_ref(*jin)
    close(y2[:, 0], y, TOL["float32"])
    close(S2, S, TOL["float32"])


# -------------------------------------------------------- the dispatcher


def test_dispatch_counts_no_cpu_launches():
    _, tin = wkv_inputs(1, 8, 1, 16)
    before = tops.launches
    tops.wkv6(*tin)
    assert tops.launches == before


def test_dispatch_rejects_bad_input():
    _, (r, k, v, w, u, s0) = wkv_inputs(1, 8, 2, 16)
    with pytest.raises(ValueError, match="one shape"):
        tops.wkv6(r, k[:, :4], v, w, u, s0)
    with pytest.raises(ValueError, match="expected u"):
        tops.wkv6(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="expected u"):
        tops.wkv6(r, k, v, w, u, s0[:, :, :8])
    with pytest.raises(ValueError, match="empty"):
        tops.wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    with pytest.raises(TypeError, match="floating"):
        tops.wkv6(r.long(), k, v, w, u, s0)
    before = tops.launches
    meta = [t.to("meta") for t in (r, k, v, w, u, s0)]
    with pytest.raises(ValueError, match="different devices"):
        tops.wkv6(*meta[:5], s0)
    with pytest.raises(ValueError, match="no wkv6 for device meta"):
        tops.wkv6(*meta)
    assert tops.launches == before


def test_cpu_grad_takes_plain_version():
    _, (r, k, v, w, u, s0) = wkv_inputs(1, 6, 1, 16)
    r.requires_grad_(True)
    y, S = tops.wkv6(r, k, v, w, u, s0)
    (y.sum() + S.sum()).backward()
    assert r.grad is not None and torch.isfinite(r.grad).all()


def test_build_is_keyed_by_source_and_lazy():
    """Each kernel's library path is ``BUILD_ROOT/<name>-<first 16 hex of
    the source's sha256>/lib<name>.so`` (flash attention's key is what it
    was before the build helper was shared); importing compiled and
    loaded nothing."""
    for mod, name in ((tK, "wkv6"), (fK, "flash_attention")):
        digest = hashlib.sha256(mod.SOURCE.read_bytes()).hexdigest()[:16]
        assert mod.library_path() == (_build.BUILD_ROOT / f"{name}-{digest}"
                                      / f"lib{name}.so")
        assert mod.library.cache_info().currsize == 0
    assert tK.SOURCE.name == "wkv6.cu" and tK.SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: logs its call and writes the file after -o
echo "$@" >> "{log}"
args="$*"
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo lib > "$2"; fi
  shift
done
case "$args" in *broken*) echo "error: broken source" >&2; exit 2;; esac
echo "ptxas info    : Used 40 registers"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc under CUDA_HOME, a build root in tmp_path."""
    log = tmp_path / "calls.log"
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", "/usr/bin:/bin")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    return log


def test_build_helper_builds_each_source_once(fake_nvcc, tmp_path):
    src = tmp_path / "one.cu"
    src.write_text("// one\n")
    so = _build.build(src, "one")
    assert so == _build.library_path(src, "one") and so.exists()
    assert so.name == "libone.so"
    assert "registers" in (so.parent / "build.log").read_text()
    assert len(fake_nvcc.read_text().splitlines()) == 1
    assert _build.build(src, "one") == so        # cached: nvcc not run
    assert len(fake_nvcc.read_text().splitlines()) == 1
    src.write_text("// one, edited\n")
    assert _build.build(src, "one") != so        # new hash, new build
    assert len(fake_nvcc.read_text().splitlines()) == 2


def test_build_helper_raises_on_a_failed_build(fake_nvcc, tmp_path):
    bad = tmp_path / "broken.cu"
    bad.write_text("// bad\n")
    with pytest.raises(RuntimeError, match="nvcc failed for broken-"):
        _build.build(bad, "broken")
    failed = _build.library_path(bad, "broken")
    assert not failed.exists()
    assert [p.name for p in failed.parent.iterdir()] == ["build.log"]
    assert "broken source" in (failed.parent / "build.log").read_text()


# -------------------------------------------------------------- the model


def perturbed_params(params, seed):
    """The reference init leaves the token-shift mixes at 0 and the scales
    at 1, which would leave their paths unchecked: add noise to them, the
    decay bias and u, identically for both packages."""
    rng = np.random.default_rng(seed)
    noisy = {"mu_x": 0.5, "mu": 0.5, "mu_k": 0.5, "mu_r": 0.5, "w0": 0.5,
             "u": 0.5, "ln_scale": 0.2, "scale": 0.2}

    def fn(path, leaf):
        scale = noisy.get(path[-1].key)
        if scale is None:
            return leaf
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * scale
        return (leaf.astype(jnp.float32) + noise).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fn, params)


def bridged(tree):
    return params_from_flat({k: np.asarray(v) for k, v in _flatten(tree)})


def test_time_mix_and_channel_mix_match_reference():
    cfg = get_smoke(ARCH).replace(dtype="float32")
    tcfg = torch_smoke(ARCH).replace(dtype="float32")
    rng = jax.random.split(jax.random.PRNGKey(4), 2)
    jtm = perturbed_params(jR.init_time_mix(rng[0], cfg, jnp.float32), 5)
    jcm = perturbed_params(jR.init_channel_mix(rng[1], cfg, jnp.float32), 6)
    ttm, tcm = bridged(jtm), bridged(jcm)
    b, d, hd = 2, cfg.d_model, cfg.rwkv.head_dim
    H = d // hd
    g = np.random.default_rng(8)
    state = g.standard_normal((b, H, hd, hd)).astype(np.float32)
    last = g.standard_normal((b, d)).astype(np.float32)
    for s in (9, 1):        # the kernel's path, then the one-step path
        x = g.standard_normal((b, s, d)).astype(np.float32)
        jy, (jS, jlast) = jR.time_mix(jnp.asarray(x), jtm, cfg,
                                      jnp.asarray(state), jnp.asarray(last))
        ty, (tS, tlast) = tR.time_mix(torch.from_numpy(x), ttm, tcfg,
                                      torch.from_numpy(state),
                                      torch.from_numpy(last))
        close(jy, ty, TOL["float32"])
        close(jS, tS, TOL["float32"])
        close(jlast, tlast, TOL["float32"])
        jc, jcl = jR.channel_mix(jnp.asarray(x), jcm, jnp.asarray(last))
        tc, tcl = tR.channel_mix(torch.from_numpy(x), tcm,
                                 torch.from_numpy(last))
        close(jc, tc, TOL["float32"])
        close(jcl, tcl, TOL["float32"])


def test_init_shapes_and_dtypes_match_reference():
    """Seeded initialisers: the same names, shapes and dtypes as the
    reference's, and the state layout of ``init_state``/``init_cache``."""
    cfg = get_smoke(ARCH)
    jm = jax_build(cfg)
    jflat = {k: v for k, v in _flatten(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0)))}
    tm = torch_build(torch_smoke(ARCH))
    assert isinstance(tm, RWKVLM)
    tflat = {k: v for k, v in _flatten_torch(
        tm.init(torch.Generator().manual_seed(0), "cpu"))}
    assert sorted(jflat) == sorted(tflat)
    for key, leaf in jflat.items():
        assert tuple(leaf.shape) == tuple(tflat[key].shape), key
        assert str(leaf.dtype) == str(tflat[key].dtype)[6:], key
    jstate = jR.init_state(cfg, 3, jnp.bfloat16)
    tstate = tR.init_state(torch_smoke(ARCH), 3, torch.bfloat16)
    jcache = jm.init_cache(3, 0)
    tcache = tm.init_cache(3, 0, "cpu")
    for j, t in ((jstate, tstate), (jcache, tcache)):
        for key in ("wkv", "tm_x", "cm_x"):
            assert tuple(j[key].shape) == tuple(t[key].shape), key
            assert str(j[key].dtype) == str(t[key].dtype)[6:], key


def _flatten_torch(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten_torch(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def model_pair(dtype="float32", seed=0):
    jm = jax_build(get_smoke(ARCH).replace(dtype=dtype))
    jp = perturbed_params(jm.init(jax.random.PRNGKey(seed)), seed + 10)
    tm = torch_build(torch_smoke(ARCH).replace(dtype=dtype))
    return jm, jp, tm, bridged(jp)


def test_prefill_decode_match_reference():
    """Logits and the whole state after prefill and after each of three
    decode steps, f32 at 2e-5."""
    jm, jp, tm, tp = model_pair()
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jcache, jlen = jax.jit(lambda p, t: jm.prefill(p, t, 0))(
        jp, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 0)
    assert tl.shape == (2, 1, jm.cfg.vocab_size) and tlen == int(jlen) == 20
    close(jl, tl, TOL["float32"])
    for key in ("wkv", "tm_x", "cm_x"):
        close(jcache[key], tcache[key], TOL["float32"])
    step = jax.jit(jm.decode)
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for _ in range(3):
        jl, jcache, jlen = step(jp, jcache, jnp.asarray(nxt), jlen)
        with torch.inference_mode():
            wkv = tcache["wkv"]
            tl, tcache, tlen = tm.decode(tp, tcache, torch.from_numpy(nxt),
                                         tlen)
            assert tcache["wkv"] is wkv          # updated in place
        assert tlen == int(jlen)
        close(jl, tl, TOL["float32"])
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for key in ("wkv", "tm_x", "cm_x"):
        close(jcache[key], tcache[key], TOL["float32"])


def test_one_token_prompt_takes_the_step_path():
    """s == 1 in prefill takes the step path, as in the reference."""
    jm, jp, tm, tp = model_pair(seed=2)
    toks = np.array([[5], [9]], np.int32)
    jl, jcache, _ = jm.prefill(jp, jnp.asarray(toks), 0)
    with torch.inference_mode():
        tl, tcache, tlen = tm.prefill(tp, torch.from_numpy(toks), 0)
    assert tlen == 1
    close(jl, tl, TOL["float32"])
    close(jcache["wkv"], tcache["wkv"], TOL["float32"])


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2),
                                       ("float32", 2e-5)])
def test_decode_matches_prefill_rwkv(dtype, tol):
    """Torch mirror of the reference's check: recurrent-state decode
    matches the parallel form (prefill 11, decode 1 against prefill 12;
    bf16 at the reference's 2e-2)."""
    tm = torch_build(torch_smoke(ARCH).replace(dtype=dtype))
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (1, 12)))
    with torch.inference_mode():
        ref, _, _ = tm.prefill(tp, toks, 0)
        _, cache, length = tm.prefill(tp, toks[:, :11], 0)
        logits, _, length = tm.decode(tp, cache, toks[:, 11:12], length)
    assert length == 12
    torch.testing.assert_close(logits[:, 0].float(), ref[:, 0].float(),
                               rtol=tol, atol=tol)


def test_bf16_prefill_matches_reference():
    jm, jp, tm, tp = model_pair("bfloat16", seed=3)
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _, _ = jm.prefill(jp, jnp.asarray(toks), 0)
    with torch.inference_mode():
        tl, _, _ = tm.prefill(tp, torch.from_numpy(toks), 0)
    assert tl.dtype == torch.bfloat16
    close(jl, tl, TOL["bfloat16"])


def test_loss_raises_naming_the_training_item():
    tm = torch_build(torch_smoke(ARCH))
    with pytest.raises(NotImplementedError, match="item 6"):
        tm.loss({}, {})
