"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, importing the port
loads neither, and ``chip_smoke.py`` fails without a card or without the
port beside it."""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_or_reference_imports():
    assert len(SOURCES) > 20
    hits = {str(p.relative_to(ROOT)): [m.group(0).strip() for m in
                                       FORBIDDEN.finditer(p.read_text())]
            for p in SOURCES}
    assert not {p: h for p, h in hits.items() if h}


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import x",
                "from repro.core import Ledger", "import repro.models",
                "    from repro import configs"):
        assert FORBIDDEN.search(bad), bad
    for fine in ("import repro_torch.core", "from repro_torch import x",
                 "# uses jax.numpy in the reference", "import jaxlib_free"):
        assert not FORBIDDEN.search(fine), fine


def _run(args, cwd, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(ROOT / "src")})


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serving, repro_torch.launch.serve, "
            "repro_torch.models.factory, repro_torch.bridge; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = _run(["-c", code], ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    out = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = _run([str(alone)], tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
