"""Checkpoints with atomic commit, the port of
``repro.checkpointing.checkpoint`` in the same on-disk format, so a
checkpoint written by either package restores bit for bit in the other.

  * save()    -- each leaf -> one .npy under <path>/tmp-<step>, a manifest
                 of key paths, shapes and logical dtypes, fsync'ed, then
                 the directory renamed to <path>/step-<step>.  bf16 (and
                 fp8) leaves are stored as unsigned-integer views, their
                 logical dtype in the manifest.  Key paths are the
                 reference's: dict keys in sorted order joined by "/", a
                 QTensor's q and scale as ".../0" and ".../1".
  * restore() -- loads into the structure of a caller-supplied TEMPLATE
                 (tensors, any device, the meta device included, and
                 QTensors, whose shapes it keeps), onto the template's
                 device or ``device``.
  * AsyncCheckpointer -- copies the state to the host at once, then
                 writes it in a background thread.  The copy is a copy
                 for a leaf already on the CPU too: the optimizer updates
                 params and moments in place while the thread writes.

Only numpy and torch: bf16 crosses through 16-bit integer views.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.optim.quant import QTensor

# dtypes np.save cannot hold: stored as unsigned-integer views
_EXOTIC = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
           torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8),
           torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8)}
_BY_NAME = {name: (dt, view) for dt, (name, _, view) in _EXOTIC.items()}


def to_host(leaf) -> tuple:
    """(array to store, logical dtype name) of one leaf, in memory of its
    own: never a view of the leaf, which may be updated in place."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype in _EXOTIC:
            name, np_dt, view = _EXOTIC[t.dtype]
            return t.view(view).numpy().view(np_dt), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def from_host(arr: np.ndarray, logical: str, device) -> torch.Tensor:
    """The tensor a stored array and its logical dtype stand for."""
    arr = np.require(arr, requirements=["C", "W"])
    if logical in _BY_NAME:
        dt, view = _BY_NAME[logical]
        signed = arr.view(np.int16 if view == torch.int16 else np.uint8)
        return torch.from_numpy(signed).view(dt).to(device)
    return torch.from_numpy(arr).to(device)


def _write(path: str, step: int, host_leaves):
    final = os.path.join(path, f"step-{step:08d}")
    tmp = os.path.join(path, f"tmp-{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (key, (arr, logical)) in enumerate(host_leaves):
        fname = f"leaf-{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape),
             "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _snapshot(tree):
    return [(key, to_host(leaf)) for key, leaf in T.flatten(tree)]


def save(path: str, step: int, tree: Any):
    """Atomic: write to <path>/tmp-<step>, fsync the manifest, rename to
    <path>/step-<step>.  A crash mid-save never corrupts the latest
    complete checkpoint."""
    return _write(path, step, _snapshot(tree))


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for d in os.listdir(path)
             if (m := re.match(r"step-(\d+)$", d))]
    return max(steps) if steps else None


def restore(path: str, step: int, template: Any, device=None) -> Any:
    """Load into ``template``'s structure, each leaf on ``device`` or, by
    default, on the template leaf's device (a meta template: the CPU)."""
    d = os.path.join(path, f"step-{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {le["key"]: le for le in manifest["leaves"]}
    t_keys = [k for k, _ in T.flatten(template)]
    if set(t_keys) != set(by_key):
        missing = set(t_keys) ^ set(by_key)
        raise ValueError(f"checkpoint/template key mismatch: {missing}")

    def load(key, like):
        le = by_key[key]
        dev = device
        if dev is None:
            dev = like.device if isinstance(like, torch.Tensor) else "cpu"
            dev = "cpu" if torch.device(dev).type == "meta" else dev
        return from_host(np.load(os.path.join(d, le["file"])), le["dtype"],
                         dev)

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        key = "/".join(prefix)
        if isinstance(node, QTensor):
            return QTensor(load(f"{key}/0", node.q),
                           load(f"{key}/1", node.scale), node.shape)
        return load(key, node)

    return build(template, ())


class AsyncCheckpointer:
    """Non-blocking saves: the state is copied to the host at once, then
    written in a background thread; wait() joins before the next save or
    at exit."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(path, exist_ok=True)

    def save(self, step: int, tree: Any):
        self.wait()
        host = _snapshot(tree)     # snapshot now

        def work():
            _write(self.path, step, host)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(int(m.group(1)) for d in os.listdir(self.path)
                       if (m := re.match(r"step-(\d+)$", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step-{s:08d}"),
                          ignore_errors=True)
