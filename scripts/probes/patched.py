"""Probe builds of the kernel library from patched copies of its sources:
``patched_csrc`` copies ``src/repro_torch/kernels/csrc`` to
``build/probes/<name>/csrc`` and applies text patches there (each old
text must occur exactly once), so the library's own sources carry no
probe switches; ``use_csrc`` points ``kernels.ops`` at such a copy (or
back at the library's sources) and loads the library built from it.

The K2 variants the probes build: ``K2_NO_TREE`` leaves out the staging
of float64 windows (``tree_step`` returns at once), ``K2_NO_TAIL`` the
last block's fold of the node sums.  Their sums are wrong by design;
only their times are read.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

Patches = Dict[str, List[Tuple[str, str]]]

K2_NO_TREE: Patches = {"agg_kernel.cuh": [(
    "                                          int64_t n_nodes) {\n",
    "                                          int64_t n_nodes) {\n"
    "  return;\n")]}
K2_NO_TAIL: Patches = {"agg_kernel.cuh": [(
    "    if (a.c[j].dtype != DT_F64) continue;\n",
    "    break;\n")]}


def merged(*parts: Patches) -> Patches:
    out: Patches = {}
    for p in parts:
        for f, pl in p.items():
            out.setdefault(f, []).extend(pl)
    return out


def patched_csrc(name: str, patches: Patches) -> Path:
    """A copy of the kernel sources under build/probes/<name>/csrc with
    ``patches`` ({file: [(old, new), ...]}) applied."""
    dst = ROOT / "build" / "probes" / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(CSRC, dst)
    for fname, pl in patches.items():
        path = dst / fname
        text = path.read_text()
        for old, new in pl:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} occurs "
                                   f"{text.count(old)} times in {fname}")
            text = text.replace(old, new)
        path.write_text(text)
    return dst


def use_csrc(ops, csrc: Path = CSRC) -> None:
    """Build (or reuse) and load the kernel library from ``csrc``."""
    ops.CSRC = csrc
    ops._LIB[0] = None
    ops.lib()
