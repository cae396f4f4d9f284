"""Times the order of K1's Hopper backward units across its persistent
blocks, at hd 256 (gemma3-4b's training) and at hd 64 and 128, for the
PyTorch port.

    python experiments/time_flash_bwd_hd256_torch.py

Prints the card's name and power limit and ptxas's registers, spills and
barriers of the hd-256 Hopper backward's kernels (preprocess, dK/dV and
dQ, with and without a softcap).  Then builds the backward's source two
more times, each a copy with the order of units or the group's bytes
rewritten:

  * "balanced": the source as it is: the units zigzag in a group
    (``unit_of``) and the passes snake (``unit_at``), groups of
    GROUP_BYTES (16 MB);
  * "plain": the units in plain pass order, groups of 8 MB (the order
    the source had at hd 64 and 128 before it balanced every head dim);
  * "balanced-8mb": balanced, groups of 8 MB.

At each shape (gemma3-4b's global and local layers, minicpm-2b's training
shape, path j's local heads, hd 128 at (2, 1024, 32), whisper-tiny's
encoder), in bf16 from chip_smoke.py's seeded inputs, the Hopper backward
of each build is called directly with the forward's LSE: the three give
the same bits (no unit's arithmetic depends on the order), checked
against ``attention_bwd_ref`` row by row at chip_smoke.py's ``ROW_TOL``;
then timed in turns (plain, balanced, balanced-8mb, balanced-8mb,
balanced, plain, twice; CUDA events, 10 calls after 2), beside the most
loaded block's share of the streamed tiles in either order
(``kernel_bwd.block_loads``) and the 7-product floor.

Ends with one JSON line.  Runs on the card only.
"""
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name, (b, sq, skv, h, hd), causal, window
SHAPES = (("gemma-global-hd256", (2, 2048, 2048, 8, 256), True, 0),
          ("gemma-local-hd256", (2, 2048, 2048, 8, 256), True, 1024),
          ("minicpm-2b-hd64", (4, 2048, 2048, 36, 64), True, 0),
          ("path-j-local-heads-hd128", (1, 4096, 4096, 16, 128), True, 0),
          ("hd128", (2, 1024, 1024, 32, 128), True, 0),
          ("whisper-encoder-hd64", (16, 1500, 1500, 6, 64), False, 0))
ZIGZAG = "*tile = r & 1 ? n_t - 1 - r / 2 : r / 2;"
SNAKE = "const int pos = k & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;"
GROUP = "constexpr long long GROUP_BYTES = 16ll << 20;"
GROUP_8MB = (GROUP, GROUP.replace("16ll", "8ll"))
# each build's rewrites of the source
VARIANTS = {
    "plain": ((ZIGZAG, "*tile = r;"), (SNAKE, "const int pos = blockIdx.x;"),
              GROUP_8MB),
    "balanced": (),
    "balanced-8mb": (GROUP_8MB,),
}
ORDER = ("plain", "balanced", "balanced-8mb")
PTXAS = r"(bwd_dkdv_hopper_kernel|bwd_dq_hopper_kernel)ILi256ELb\dE|" \
        r"bwd_preprocess_hopperILi256E"


def ptxas_lines(log):
    """ptxas's summary of each hd-256 Hopper backward kernel in build.log:
    registers, barriers, stack and spills; and any warning about wgmma
    (ptxas serialising them)."""
    out, fn_name, spill = [], "", ""
    for line in log.read_text().splitlines():
        if "wgmma" in line.lower() and "warning" in line.lower():
            out.append(line.strip())
        elif "Function properties for" in line:
            fn_name = line.split("for ")[1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and re.search(PTXAS,
                                                                  fn_name):
            out.append(f"{fn_name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


def variant_source(kernel_bwd, _build, name):
    """A copy of the backward's source with ``VARIANTS[name]``'s rewrites,
    under the build directory (the source itself where there are none)."""
    if not VARIANTS[name]:
        return kernel_bwd.SOURCE
    src = kernel_bwd.SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            sys.exit(f"time_flash_bwd_hd256_torch: {old!r} is not in the "
                     f"source once")
        src = src.replace(old, new)
    path = _build.BUILD_ROOT / "variants" / f"{kernel_bwd.NAME}-{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return path


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import checks, kernel, kernel_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    if not torch.cuda.is_available():
        sys.exit("time_flash_bwd_hd256_torch: no CUDA device")
    card = cs.card_line()
    print(card)
    sources = {u: variant_source(kernel_bwd, _build, u) for u in ORDER}
    with ThreadPoolExecutor(len(ORDER) + 2) as pool:
        builds = {u: pool.submit(_build.build, path,
                                 f"{kernel_bwd.NAME}_{u.replace('-', '_')}")
                  for u, path in sources.items()
                  if path != kernel_bwd.SOURCE}
        pool.submit(kernel.library).result()
        pool.submit(kernel_bwd.library).result()
        libs = {u: f.result() for u, f in builds.items()}
    log = _build.library_path(kernel_bwd.SOURCE,
                              kernel_bwd.NAME).parent / "build.log"
    ptxas = ptxas_lines(log)
    for line in ptxas:
        print(f"[ptxas] {line}")
    as_built = kernel_bwd.build

    def use(u):
        """Points kernel_bwd's launchers made from now on at build ``u``
        (the source as it is for None and "balanced")."""
        kernel_bwd.build = (lambda: libs[u]) if u in libs else as_built
        kernel_bwd.library.cache_clear()

    tol = cs.ROW_TOL[torch.bfloat16]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 35)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    result = {"card": card, "ptxas": ptxas, "shapes": {}}
    failed = []
    for name, shape, causal, window in SHAPES:
        hd = shape[4]
        q, k, v, do = cs._bwd_inputs(shape, torch.bfloat16, 2.0, "plain", gen)
        kw = dict(causal=causal, window=window, softcap=0.0)
        lse = kernel.lse_buffer(q)
        calls, outs = {}, {}
        with torch.no_grad():
            o = kernel.flash_attention_cuda(q, k, v, "hopper", lse=lse, **kw)
            for u in ORDER:
                use(u)
                calls[u], outs[u] = kernel_bwd.launcher(
                    q, k, v, o, do, "hopper", lse=lse, **kw)
                calls[u]()
            use(None)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for u in ORDER[1:]
                       for a, b in zip(outs[u][:3], outs["plain"][:3]))
            f32 = [t.float() for t in (q, k, v, o, do)]
            ref = attention_bwd_ref(*f32, **kw)
            scales = checks.bwd_row_scales(*f32, **kw)
            errs = {g: checks.grad_row_err(a, r, m) for g, a, r, m in
                    zip(("dq", "dk", "dv"), outs["plain"], ref, scales)}
            del f32, ref, scales
            torch.cuda.empty_cache()
            ok = same and all(np.isfinite(e) and e <= tol
                              for e in errs.values())
            print(f"[check] {name} {shape} causal={causal} window={window}: "
                  f"worst row rel err "
                  f"{', '.join(f'{g} {e:.3e}' for g, e in errs.items())} "
                  f"(limit {tol:g}); the three orders "
                  f"{'bit-identical' if same else 'DIFFER'} -> "
                  f"{'ok' if ok else 'FAILED'}")
            if not ok:
                failed.append(name)
            turns = [(u, cs.time_ms(calls[u])) for _ in range(2)
                     for u in ORDER + ORDER[::-1]]
        ms = {u: float(np.mean([t for w, t in turns if w == u]))
              for u in ORDER}
        balance = {f"{u} {kn}": max(loads) / float(np.mean(loads))
                   for u in ORDER[:2] for kn in ("dkdv", "dq")
                   for loads in [kernel_bwd.block_loads(
                       *shape, causal=causal, window=window, kernel=kn,
                       n_sm=n_sm, balance=u == "balanced")]}
        pairs = cs.bwd_bound(shape, torch.bfloat16, causal, window)[2]
        floor_ms = 14 * hd * pairs / cs.PEAK_FLOPS[torch.bfloat16] * 1e3
        print(f"[time] {name}: in turns "
              f"{', '.join(f'{u} {t:.4f}' for u, t in turns)} ms; mean "
              f"{', '.join(f'{u} {t:.4f}' for u, t in ms.items())} ms; "
              f"balanced / plain "
              f"{ms['balanced'] / ms['plain']:.3f}, balanced-8mb / balanced "
              f"{ms['balanced-8mb'] / ms['balanced']:.3f}; most loaded block "
              f"/ mean {', '.join(f'{u} {x:.3f}' for u, x in balance.items())}"
              f"; 7-product floor {floor_ms:.4f} ms | {card}")
        result["shapes"][name] = {
            "shape": list(shape), "causal": causal, "window": window,
            "row_err": errs, "same_bits": same, "ms": ms, "turns": turns,
            "balance": balance, "floor_ms": floor_ms}
        del q, k, v, do, o, lse, calls, outs
        torch.cuda.empty_cache()
    result["failed"] = failed
    print(json.dumps(result))
    if failed:
        sys.exit(f"time_flash_bwd_hd256_torch: {len(failed)} case(s) failed")


if __name__ == "__main__":
    main()
