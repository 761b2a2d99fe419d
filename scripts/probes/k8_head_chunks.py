#!/usr/bin/env python3
"""K8 at the serve prefill's shape (fused and model layout, float32) with
each head-chunk size GH a CTA may take (8, 4, 2, 1 of a KV head's 8 query
heads): ``selfcheck.run_case``'s L2 write-flushed ms.  The launch plan
(``flash_attention.launch_plan``) takes the largest GH dividing G.

Usage:  python scripts/probes/k8_head_chunks.py
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))


def main() -> int:
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import selfcheck as SC
    if not torch.cuda.is_available():
        print("k8_head_chunks: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    plan = FA.launch_plan
    try:
        for gh in (8, 4, 2, 1):
            FA.launch_plan = lambda B, H, KV, Sq, gh=gh: (gh, 128 // gh, 0)
            for fused in (True, False):
                case = SC.k8_case(8, 64, 8, 512, 512, 128, seed=22, dev=dev,
                                  fused=fused)
                r = SC.run_case(case, iters=20)
                print(json.dumps({"GH": gh, "fused": fused, "ok": r["ok"],
                                  "ms": r["ms"], "ms_timer": r["ms_timer"]}))
                if not r["ok"]:
                    return 1
    finally:
        FA.launch_plan = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
