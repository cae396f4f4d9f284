"""Deterministic synthetic token pipeline: a copy of ``repro.data.pipeline``
(numpy only, so the port keeps its own).  Batches are numpy arrays; the
trainer moves them to the device.

Shard-aware: every (step, dp_rank) pair maps to a unique, reproducible
slice of the stream — a restarted/elastically-resized job re-derives the
identical global batch from (seed, step) alone, which is what makes
checkpoint/restart bit-exact and elastic re-sharding safe.  A background
Prefetcher double-buffers batches so host data prep overlaps device
compute.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dp_rank: int = 0
    dp_size: int = 1

    def __post_init__(self):
        assert self.global_batch % self.dp_size == 0
        self.local_batch = self.global_batch // self.dp_size

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a given step: a Philox stream keyed on
        (seed, step, rank) — no state to checkpoint."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, step, self.dp_rank]))
        # Markov-ish stream: mixture of a repeated pattern + noise so the
        # model has learnable structure (loss decreases in examples).
        base = rng.integers(0, self.vocab_size,
                            (self.local_batch, self.seq_len + 1),
                            dtype=np.int32)
        pattern = rng.integers(0, self.vocab_size, (16,), dtype=np.int32)
        mask = rng.random((self.local_batch, self.seq_len + 1)) < 0.7
        idx = np.arange(self.seq_len + 1) % 16
        base[mask] = np.broadcast_to(pattern[idx],
                                     base.shape)[mask]
        return {"tokens": base[:, :-1], "labels": base[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Double-buffered background prefetch (depth-N pipeline)."""

    def __init__(self, dataset, start_step: int = 0, depth: int = 2):
        self.dataset = dataset
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.dataset.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self, timeout: Optional[float] = 10.0):
        return self._q.get(timeout=timeout)

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
