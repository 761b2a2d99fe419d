"""Probe builds of the kernel library from patched copies of its sources:
``patched_csrc`` copies ``src/repro_torch/kernels/csrc`` to
``build/probes/<name>/csrc`` and applies text patches there (each old
text must occur exactly once), so the library's own sources carry no
probe switches; ``use_csrc`` points ``kernels.ops`` at such a copy (or
back at the library's sources) and loads the library built from it.

The K2 variants the probes build: ``K2_NO_TREE`` leaves out the staging
of float64 windows (``tree_step`` returns at once: the loop K2, A6 and
the first stacked design), ``K2_NO_TAIL`` the last block's fold of the
node sums (the same kernels).  For the second stacked design
(``rows_agg_kernel``): ``K2S_NO_WINDOWS`` leaves out its window and node
sums (``window_step`` returns at once), ``K2S_NO_GROUPS`` its tickets and
folds of the groups of 32 nodes, ``K2S_NO_TAIL`` the folds above the
first level of groups.  Their sums are wrong by design; only their times
are read.

The K8 variants (float32's ``flash_wg_kernel``): ``K8_NO_QK`` leaves out
the S = Q K^T products (S stays 0), ``K8_NO_PV`` the O += P V products.
``python scripts/probes/patched.py k8 DIR`` writes the copies
``DIR/k8_{all,no_qk,no_pv,no_mma}/csrc`` that ``run.sh`` builds
``k8_parts.cu`` against.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

Patches = Dict[str, List[Tuple[str, str]]]

K2_NO_TREE: Patches = {"agg_kernel.cuh": [(
    "  sel &= valid_bits(r);\n  __syncthreads();",
    "  return;\n  sel &= valid_bits(r);\n  __syncthreads();")]}
K2_NO_TAIL: Patches = {"agg_kernel.cuh": [(
    "    if (a.c[j].dtype != DT_F64) continue;\n",
    "    break;\n")]}
K2S_NO_WINDOWS: Patches = {"filter_aggregate.cu": [(
    "  sel &= valid_bits(r);\n#pragma unroll\n  for (int b = 0; b < RUN; ++b) "
    "{\n    const int row = 64 * (b >> 1) + 2 * lane + (b & 1);\n    stg[",
    "  return;\n  sel &= valid_bits(r);\n#pragma unroll\n  for (int b = 0; "
    "b < RUN; ++b) {\n    const int row = 64 * (b >> 1) + 2 * lane + (b & 1)"
    ";\n    stg[")]}
K2S_NO_TAIL: Patches = {"filter_aggregate.cu": [(
    "    if (n_above == 1) return;\n", "    return;\n")]}
K2S_NO_GROUPS: Patches = {"filter_aggregate.cu": [(
    "  if (nf > 0 && warp < CWARPS) {\n    // a ticket a chunk",
    "  if (false) {\n    // a ticket a chunk")]}


_K8_QK = """#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const int qo = (kk / 4) * C::QBLK + wg * 64 * SPAN + (kk % 4) * 32;"""
_K8_PV = """#pragma unroll
    for (int kj = 0; kj < NKT; ++kj) {
      wgmma_rs<HD>(acc, pl[kj], sw128(vhi + kj * 32));"""
K8_NO_QK: Patches = {"flash_attention.cu": [(
    _K8_QK, """#pragma unroll
    for (int i = 0; i < NKT * 4; ++i) sc[i] = 0.f;
    for (int kk = 0; kk < 0; ++kk) {
      const int qo = (kk / 4) * C::QBLK + wg * 64 * SPAN + (kk % 4) * 32;""")]}
K8_NO_PV: Patches = {"flash_attention.cu": [(
    _K8_PV, """#pragma unroll
    for (int kj = 0; kj < 0; ++kj) {
      wgmma_rs<HD>(acc, pl[kj], sw128(vhi + kj * 32));""")]}


def merged(*parts: Patches) -> Patches:
    out: Patches = {}
    for p in parts:
        for f, pl in p.items():
            out.setdefault(f, []).extend(pl)
    return out


def patched_csrc(name: str, patches: Patches, src: Path = CSRC) -> Path:
    """A copy of the kernel sources ``src`` under build/probes/<name>/csrc
    with ``patches`` ({file: [(old, new), ...]}) applied."""
    dst = ROOT / "build" / "probes" / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
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


def _k8_copies(out: Path) -> None:
    for name, patches in (("all", {}), ("no_qk", K8_NO_QK),
                          ("no_pv", K8_NO_PV),
                          ("no_mma", merged(K8_NO_QK, K8_NO_PV))):
        dst = out / f"k8_{name}" / "csrc"
        src = patched_csrc(f"k8_{name}", patches)
        if dst.resolve() != src.resolve():
            if dst.exists():
                shutil.rmtree(dst)
            shutil.copytree(src, dst)


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "k8":
        sys.exit("usage: python scripts/probes/patched.py k8 OUT_DIR")
    _k8_copies(Path(sys.argv[2]))
