#!/usr/bin/env python3
"""A6 (fused index chain) and stacked K2 at ``selfcheck.rung_cases``'
shapes, split launch by launch: the device µs a call of each kernel,
memset and copy they run, by name (``time_model_kernels.split_us``, L2
write-flushed before each call).  Then the same cases built without the
last block's fold of the float64 node sums (``patched.K2_NO_TAIL``, and
for the second stacked design ``K2S_NO_TAIL``), without the staging and
window sums of the float64 values (``K2_NO_TREE``, ``K2S_NO_WINDOWS``),
without the second
stacked design's group tickets and folds (``K2S_NO_GROUPS``), and
without all of them, which leaves the scan and the partials: patched
copies of the sources under build/probes, whose sums are wrong by
design and only their times are read.  One JSON line a (build, case).

Usage:  python scripts/probes/a6_k2_split.py [--src DIR] [--iters 50]
        (from the repository root; ``--src``: a tree's ``src`` directory,
        whose package and kernel sources are split instead of this
        checkout's; a tree without the second stacked design gets no
        ``K2S_*`` patches and no ``no_groups`` build)
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "scripts" / "probes"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import selfcheck as SC
    from time_model_kernels import split_us
    if not torch.cuda.is_available():
        print("a6_k2_split: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    from patched import (K2_NO_TAIL, K2_NO_TREE, K2S_NO_GROUPS, K2S_NO_TAIL,
                         K2S_NO_WINDOWS, merged, patched_csrc, use_csrc)
    csrc = Path(ops.CSRC)
    second = "rows_agg_kernel" in (csrc / "filter_aggregate.cu").read_text()
    tails = merged(K2_NO_TAIL, K2S_NO_TAIL) if second else K2_NO_TAIL
    trees = merged(K2_NO_TREE, K2S_NO_WINDOWS) if second else K2_NO_TREE
    groups = K2S_NO_GROUPS if second else {}
    builds = [("whole", csrc),
              ("no_tail", patched_csrc("a6_no_tail", tails, csrc)),
              ("no_tree", patched_csrc("a6_no_tree", trees, csrc))]
    if second:
        builds.append(("no_groups", patched_csrc("a6_no_groups", groups,
                                                 csrc)))
    builds.append(("none", patched_csrc(
        "a6_none", merged(trees, tails, groups), csrc)))
    for name, built in builds:
        use_csrc(ops, built)
        for case in SC.rung_cases(dev):
            if case["kernel"] not in ("fused_index_chain",
                                      "filter_aggregate_stacked"):
                continue
            r = SC.run_case(case, iters=args.iters, timed=name == "whole")
            split = split_us(case["run"], args.iters)
            print(json.dumps({"build": name, "label": case["label"],
                              "kernel": case["kernel"],
                              "ok": r["ok"], "ms": r.get("ms"),
                              "bound_ms": r["bound_ms"],
                              "split_us": split,
                              "span_us": split.pop("span")}),
                  flush=True)
    use_csrc(ops, csrc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
