"""Whether K2's kernels compile to the same SASS as another copy of their
source (the parent commit's, say).

Builds each pair of sources with the port's nvcc flags
(``repro_torch.kernels._build``) into ``build/repro_torch/``, lists the
SASS of both libraries with cuobjdump, and compares the instructions of
every kernel whose mangled name holds ``--match``, instantiation by
instantiation, their names left out (the training mode's template
argument ``Lb0E``, the hash of the anonymous namespace and the parameter
list are dropped from a name before pairing: a kernel's training mode
may add a parameter after the parent's, whose offsets, which the
instructions name, then stay the parent's; kernels with ``Lb1E``, the
training mode, have no counterpart; within an instruction, a callee's
name loses the hash too).  Prints one line per instantiation and exits 1 if any
differs or has no counterpart.  Needs
nvcc and the card's toolkit:

    git show <parent>:src/repro_torch/kernels/rwkv6/csrc/wkv6.cu \\
        > build/parent/wkv6.cu
    python3 experiments/wkv6_sass_same_torch.py \\
        --pair src/repro_torch/kernels/rwkv6/csrc/wkv6.cu \\
               build/parent/wkv6.cu wkv6_kernel
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402


def sass(library: Path) -> dict:
    """{mangled name: [instruction text, ...]} of a library."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(library)],
                         capture_output=True, text=True, check=True,
                         timeout=600).stdout
    funcs, body = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            body = funcs[m.group(1)] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if body is not None and m:
            # a call names its callee with the namespace's hash
            body.append(re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                               " ".join(m.group(1).split())))
    return funcs


def _key(name: str) -> str:
    """A kernel's mangled name without what differs between two builds of
    one kernel: the hash nvcc gives the source's anonymous namespace, the
    training mode's template argument Lb0E, and the parameter list (after
    the template arguments' closing "EEv")."""
    name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                  name).replace("Lb0E", "")
    return name.split("EEv", 1)[0]


def compare(source: Path, other: Path, match: str, tag: str) -> bool:
    libs = [_build.build(src, f"{tag}_{i}") for i, src in
            enumerate((source, other))]
    new, old = ({_key(name): body for name, body in sass(lib).items()
                 if match in name and "Lb1E" not in name} for lib in libs)
    same = True
    for name in sorted(set(new) | set(old)):
        if name not in new or name not in old:
            print(f"[sass] {match}: {name} only in "
                  f"{'the source' if name in new else 'the other'}")
            same = False
            continue
        equal = new[name] == old[name]
        same &= equal
        print(f"[sass] {match}: {name}: {len(new[name])} and "
              f"{len(old[name])} instructions, "
              f"{'the same' if equal else 'DIFFERENT'}")
    if not new:
        print(f"[sass] {match}: no kernel matches")
        same = False
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pair", nargs=3, action="append", required=True,
                    metavar=("SOURCE", "OTHER", "MATCH"),
                    help="two sources and a fragment of the kernels' names")
    args = ap.parse_args()
    ok = True
    for i, (source, other, match) in enumerate(args.pair):
        ok &= compare(Path(source).resolve(), Path(other).resolve(), match,
                      f"sass_same{i}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
