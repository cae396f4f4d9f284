"""Build of the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes by each kernel module.

Each library goes into ``build/repro_torch/<name>-<hash of its source>/``
at the repository root, so an edited source gets a new directory and is
rebuilt, and an unchanged one is built once.  nvcc's output (ptxas
register and spill counts) is kept beside the library as ``build.log``.
Nothing is linked beyond what nvcc links by default (the CUDA runtime,
statically): flash attention's Hopper variant looks up libcuda's
``cuTensorMapEncodeTiled`` at run time through the CUDA runtime's entry
point query, not through ``-lcuda``.  Nothing
here runs at import time.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def library_path(source: Path, name: str) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def build(source: Path, name: str) -> Path:
    """Compiles ``source`` unless a library of the same source hash is
    already built; returns the library's path.  A failed build raises
    with nvcc's output and leaves no library behind."""
    so = library_path(source, name)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (so.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {so.parent.name} "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so
