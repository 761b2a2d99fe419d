#!/usr/bin/env python3
"""K8's float32 backward at the train step's shape (q [2, 2048, 64, 128],
k/v [2, 2048, 8, 128], causal) with parts of its two tensor-core kernels
compiled out, to see where a tile's time goes: ``all`` (the library's
kernels), ``no_split`` (no tile is split into TF32 hi and lo, as loaded or
transposed: the products read whatever the buffers hold), ``no_mma`` (no
wgmma is issued: the splits, barriers, masks and hand-overs only) and
``no_split_no_mma`` (loads, barriers and the epilogue).  Only times are
read; the gradients of every variant but ``all`` are wrong by design.

Each variant is a patched copy of the kernel sources
(``patched.patched_csrc``, under ``build/probes/k8b_<name>``) holding only
the files the backward needs (its forward for the row logsumexp, and
``range_mask.cu`` for ``rt_error_string``); the copies build in parallel,
then each is timed in a process of its own, in turn: device µs a call by
kernel name and the union of their intervals (``split``, after the
repository's write flush of L2, as ``scripts/time_model_kernels.py``).

Usage:  python scripts/probes/k8_bwd_parts.py
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from patched import merged, patched_csrc, use_csrc  # noqa: E402

KEEP = ("flash_attention.cu", "flash_attention_bwd.cu", "range_mask.cu")

NO_SPLIT = {"flash_attention_bwd.cu": [
    ("    for (int i = tid; i < 2 * C::QS / 16; i += WT) {   // Q then dO",
     "    for (int i = tid; i < 0; i += WT) {   // Q then dO"),
    ("    split_t<HD, QTW>(raw, C::QBLK, sb + C::O_QTH, sb + C::O_QTL, tid, "
     "WT);\n    split_t<HD, QTW>(raw + C::QS, C::QBLK, sb + C::O_DTH, "
     "sb + C::O_DTL, tid,\n                     WT);\n", ""),
    ("    for (int i = tid; i < 2 * C::KS / 16; i += WT) {   // K then V\n",
     "    for (int i = tid; i < 0; i += WT) {   // K then V\n"),
    ("    split_t<HD, KTW>(raw, C::KBLK, sb + C::O_KTH, sb + C::O_KTL, tid, "
     "WT);\n", "")]}
NO_MMA = {"flash_attention_bwd.cu": [
    ("  for (int kk = 0; kk < HD / 8; ++kk) {\n    const int ao = (kk / 4) * "
     "a_blk", "  for (int kk = 0; kk < 0; ++kk) {\n    const int ao = (kk / "
     "4) * a_blk"),
    ("  for (int kj = 0; kj < 4; ++kj) {\n    wgmma_rs<N>(acc, pl[kj]",
     "  for (int kj = 0; kj < 0; ++kj) {\n    wgmma_rs<N>(acc, pl[kj]")]}
VARIANTS = {"all": {}, "no_split": NO_SPLIT, "no_mma": NO_MMA,
            "no_split_no_mma": merged(NO_SPLIT, NO_MMA)}


def copy(name: str) -> Path:
    dst = patched_csrc(f"k8b_{name}", VARIANTS[name])
    for p in dst.glob("*.cu"):
        if p.name not in KEEP:
            p.unlink()
    return dst


def one(name: str, build_only: bool) -> int:
    from repro_torch.kernels import ops
    use_csrc(ops, ROOT / "build" / "probes" / f"k8b_{name}" / "csrc")
    if build_only:
        return 0
    import torch
    from repro_torch.kernels import selfcheck as SC
    from time_model_kernels import split_us
    dev = torch.device("cuda", 0)
    case = SC.train_cases(dev)[1]
    split = split_us(case["run"], 10)
    print(json.dumps({"variant": name,
                      "split_us": {k: round(v, 1) for k, v in split.items()}}),
          flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3:
        return one(sys.argv[1], sys.argv[2] == "build")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    for name in VARIANTS:
        copy(name)
    builds = [subprocess.Popen([sys.executable, __file__, name, "build"])
              for name in VARIANTS]
    if any(p.wait() != 0 for p in builds):
        return 1
    for name in VARIANTS:
        rc = subprocess.run([sys.executable, __file__, name,
                             "time"]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
