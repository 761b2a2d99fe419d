#!/usr/bin/env python3
"""A6 (fused index chain) and stacked K2 at ``selfcheck.rung_cases``'
shapes, split launch by launch: the device µs a call of each kernel,
memset and copy they run, by name (``time_model_kernels.split_us``, L2
write-flushed before each call).  Then the same cases built without the
last block's fold of the float64 node sums (a patched copy of the
sources under build/probes, ``patched.K2_NO_TAIL``), which leaves the
scan and the partials: the variants' sums are wrong by design and only
their times are read.  One JSON line a (build, case).

Usage:  python scripts/probes/a6_k2_split.py [--iters 50]
        (from the repository root)
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
    args = ap.parse_args()
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
    from patched import CSRC, K2_NO_TAIL, patched_csrc, use_csrc
    for name, csrc in (("whole", CSRC),
                       ("no_tail", patched_csrc("a6_no_tail", K2_NO_TAIL))):
        use_csrc(ops, csrc)
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
    use_csrc(ops)
    return 0


if __name__ == "__main__":
    sys.exit(main())
