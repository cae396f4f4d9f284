"""Path j of ``chip_smoke.py`` (phase ``mesh_train``: mistral-nemo-12b at
full width cut to 4 layers, 3 steps of 4 x 4096 tokens in 2 microbatches
with grad_specs) on four cards: the same (2, 2) ("data", "model") mesh,
one rank a card over NCCL, held step by step to the one-device run of
the same cut on card 0 (``MESH_TRAIN_LIMIT``), with the faults on rank
(0, 1) as the phase shows them.

    python experiments/mesh_train_cards_torch.py      # needs 4 cards

Builds K1's two libraries, then prints every card's name and power
limit, the one-device run, each step's loss, grad_norm, rank 0's step
time, the largest peak memory a rank, and rank 0's collectives by op
(bytes, calls, host seconds: over NCCL the enqueue alone), and one JSON
line.  Runs on the card only.
"""
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

CARDS = 4


def main():
    if torch.cuda.device_count() < CARDS:
        print(f"needs {CARDS} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print("\n".join(cards))
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda m: m.build(), (kernel, kernel_bwd)))
    cut = {"n_layers": cs.MESH_TRAIN["n_layers"],
           "steps": cs.MESH_TRAIN["steps"]}
    want = cs.mesh_train_reference(cut)
    print(f"[cards] one device (card 0): losses {want['loss']}, grad_norms "
          f"{want['grad_norm']}, {[round(t, 1) for t in want['step_ms']]} "
          f"ms a step, peak {want['peak_gb']:.2f} GB")
    outs = cs.run_mesh_ranks(cs.MESH_SHAPE, "nccl", [("path_j", cut, True)],
                             runner="_mesh_train_path", cards=CARDS)
    _, errs = cs._mesh_train_check(f"nccl on {CARDS} cards", outs, want,
                                   cs.MESH_SHAPE, cards[0])
    faults = {name: max(cs._rel(outs[c]["path_j"]["faults"][name],
                                want["grad_norm"][0]) for c in outs)
              for name in cs.MESH_TRAIN_FAULTS}
    print(f"[cards] faults on rank (0, 1), worst rank's grad_norm rel err "
          f"at step 1: {faults}")
    steps = outs[(0, 0)]["path_j"]["steps"]
    print("mesh_train_cards " + json.dumps({
        "cards": cards, "one_device_step_ms": want["step_ms"],
        "step_ms_rank0": [st["step_ms"] for st in steps],
        "worst_rel_err": errs, "faults": faults,
        "peak_gb_by_rank": {str(c): max(st["peak_gb"] for st in
                                        outs[c]["path_j"]["steps"])
                            for c in outs},
        "bytes_a_step_rank0": steps[-1]["bytes"],
        "calls_a_step_rank0": steps[-1]["calls"],
        "seconds_a_step_rank0": steps[-1]["seconds"],
        "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
