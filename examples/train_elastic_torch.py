"""End-to-end elastic training on the PyTorch port: the counterpart of
``examples/train_elastic.py``.

Trains a scaled-down dense LM (mistral-nemo's smoke config cut to 4
layers at d_model 128) on the deterministic synthetic pipeline with:
  * AdamW + cosine schedule, remat'ed train step (K1's forward and
    backward kernels on the card),
  * async checkpoints every --ckpt-every steps,
  * a SIMULATED batch-system preemption mid-run: the state is dropped,
    the latest checkpoint restored and held bit for bit to what was
    saved, and training continues; the continued losses are held to an
    uninterrupted run of the same seed, bit for bit,
  * periodic evaluation offloaded to rFaaS-leased executors whose
    availability churns (elastic spare capacity, paper §5.3).

    PYTHONPATH=src python examples/train_elastic_torch.py --steps 60
    PYTHONPATH=src python examples/train_elastic_torch.py --device cpu

Runs on the card unless ``--device`` says otherwise.
"""
import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpointing import AsyncCheckpointer, latest_step, restore
from repro_torch.checkpointing.checkpoint import to_host
from repro_torch.configs import get_smoke
from repro_torch.core import (BatchSystem, FunctionLibrary, Invoker, Ledger,
                              ResourceManager)
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch.train import to_device
from repro_torch.models.factory import build_model
from repro_torch.optim import AdamW, AdamWConfig, cosine
from repro_torch.training.step import make_train_step


def make_cfg():
    return get_smoke("mistral-nemo-12b").replace(
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
        d_ff=512, vocab_size=2048)


def host_copy(tree):
    """{key: (array, logical dtype)}: the bits a checkpoint stores."""
    return {key: to_host(leaf) for key, leaf in T.flatten(tree)}


def same_bits(tree, host):
    """Keys of ``tree`` whose bits differ from ``host`` (host_copy)."""
    now = host_copy(tree)
    bad = [k for k in host if k not in now]
    for key, (arr, logical) in now.items():
        want, want_logical = host.get(key, (None, None))
        if (want is None or logical != want_logical
                or arr.shape != want.shape
                or arr.tobytes() != want.tobytes()):
            bad.append(key)
    return bad


class ElasticRun:
    """The model, optimizer, data stream and the rFaaS eval stack."""

    def __init__(self, steps, device=None, batch=4, seq=64, ckpt_every=10,
                 log=print):
        self.device = resolve_device(device)
        self.cfg = make_cfg()
        self.model = build_model(self.cfg)
        self.opt = AdamW(lambda s: cosine(s, peak_lr=3e-3, warmup=20,
                                          total=steps),
                         AdamWConfig(weight_decay=0.01))
        self.step_fn = make_train_step(self.model, self.opt)
        self.data = SyntheticLMDataset(self.cfg.vocab_size, seq, batch,
                                       seed=1)
        self.ckpt_every, self.log = ckpt_every, log
        # --- rFaaS eval offload: leased spare capacity with churn
        self.ledger = Ledger()
        self.rm = ResourceManager(n_replicas=2)
        self.cluster = BatchSystem(self.rm, self.ledger, n_nodes=3,
                                   workers_per_node=2, hot_period=5.0,
                                   seed=5)
        self.cluster.release_idle()
        lib = FunctionLibrary("eval")
        model = self.model

        @lib.function
        def eval_batch(payload):
            params, batch = payload
            with torch.no_grad():
                return float(model.loss(params, batch)[0])

        self.invoker = Invoker("train-job", self.rm, lib, seed=11)
        self.invoker.allocate(2)
        self.evals = []

    def fresh_state(self):
        gen = torch.Generator(device=self.device).manual_seed(0)
        params = self.model.init(gen, self.device)
        return params, self.opt.init(params)

    def run_range(self, params, opt_state, start, stop, tag, ckpt=None):
        losses = []
        for step in range(start, stop):
            batch = to_device(self.data.batch_at(step), self.device)
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            losses.append(float(metrics["loss"]))
            if ckpt is not None and (step + 1) % self.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
            if ckpt is not None and (step + 1) % 20 == 0:
                self._eval(params, step, losses[-1], tag)
        return params, opt_state, losses

    def _eval(self, params, step, loss, tag):
        self.cluster.churn_step(p_claim=0.3, p_release=0.5)  # elasticity
        if self.invoker.n_workers < 2:       # re-lease after retrieval
            self.invoker.allocate(2 - self.invoker.n_workers)
        if self.invoker.n_workers == 0:
            self.log(f"[{tag}] step {step + 1:4d} loss={loss:.4f} "
                     f"eval=skipped (no spare capacity this round)")
            return
        futs = [self.invoker.submit(
            "eval_batch",
            (params, to_device(self.data.batch_at(10_000 + i), self.device)))
            for i in range(2)]
        evals = [f.get() for f in futs]
        self.evals.append(float(np.mean(evals)))
        self.log(f"[{tag}] step {step + 1:4d} loss={loss:.4f} "
                 f"eval={np.mean(evals):.4f} workers={self.invoker.n_workers}")

    def close(self):
        self.invoker.deallocate()
        self.rm.stop()


def train_elastic(steps=60, preempt_at=None, ckpt_every=10, batch=4, seq=64,
                  device=None, log=print):
    """Trains to ``preempt_at``, checkpoints, drops the state, restores,
    continues to ``steps``, then trains the same seed uninterrupted.
    Returns what a caller checks: "restored_same_bits" (keys whose
    restored bits differ from the saved ones: none), "losses" (the
    interrupted run), "straight" (the uninterrupted one), "evals" and
    "bill"."""
    preempt_at = preempt_at or steps // 2
    run = ElasticRun(steps, device, batch, seq, ckpt_every, log)
    ckpt_dir = tempfile.mkdtemp(prefix="rfaas_ckpt_")
    ckpt = AsyncCheckpointer(ckpt_dir, keep=3)
    try:
        # ---- phase 1: train until the simulated preemption
        t0 = time.time()
        params, opt_state = run.fresh_state()
        params, opt_state, losses1 = run.run_range(params, opt_state, 0,
                                                   preempt_at, "run1", ckpt)
        state = {"params": params, "opt": opt_state}
        saved = host_copy(state)
        ckpt.save(preempt_at, state)
        ckpt.wait()
        log(f"--- simulated node retrieval at step {preempt_at}: job "
            f"killed, state dropped ---")
        del params, opt_state, state

        # ---- phase 2: restart, restore, continue
        last = latest_step(ckpt_dir)
        template = dict(zip(("params", "opt"), run.fresh_state()))
        state = restore(ckpt_dir, last, template)
        del template
        bad = same_bits(state, saved)
        log(f"restored checkpoint step-{last}: {len(saved)} leaves, "
            f"{len(bad)} differ from the saved bits")
        params, opt_state, losses2 = run.run_range(
            state["params"], state["opt"], last, steps, "run2", ckpt)
        ckpt.wait()
        losses = losses1 + losses2
        log(f"loss: start {np.mean(losses[:5]):.4f} -> end "
            f"{np.mean(losses[-5:]):.4f}  ({steps} steps in "
            f"{time.time() - t0:.1f}s)")
        del params, opt_state, state

        # ---- the same seed, uninterrupted
        params, opt_state = run.fresh_state()
        _, _, straight = run.run_range(params, opt_state, 0, steps, "straight")
        same = [a == b for a, b in zip(losses, straight)]
        log(f"uninterrupted run: {sum(same)} of {steps} losses bit-identical"
            f" to the interrupted run's")
    finally:
        run.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    bill = run.ledger.bill("train-job")
    log(f"bill: {bill}")
    return {"restored_same_bits": bad, "losses": losses,
            "straight": straight, "preempt_at": preempt_at,
            "evals": run.evals, "bill": bill}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--preempt-at", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    out = train_elastic(args.steps, args.preempt_at, args.ckpt_every,
                        args.batch, args.seq, args.device)
    losses = out["losses"]
    assert not out["restored_same_bits"], out["restored_same_bits"]
    assert losses == out["straight"], "the restart changed the losses"
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), "loss did not drop"


if __name__ == "__main__":
    main()
