#!/usr/bin/env python3
"""K2 (fused filter-aggregate) at n = 2**16 and 2**19 with 0-2 predicate
and 1-2 aggregate columns of the columnar path's kinds: how its time
splits into a fixed part and a part that grows with the bytes.  Each line
is ``selfcheck.run_case``'s result (L2 write-flushed ms, bound).

Usage:  python scripts/probes/k2_scaling.py
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))


def main() -> int:
    import torch
    from repro_torch.kernels import selfcheck as SC
    if not torch.cuda.is_available():
        print("k2_scaling: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    shapes = [(["ts", "id"], ["id", "f64"]), ([], ["id"]), ([], ["f64"]),
              (["ts", "id"], []), ([], ["id", "ts"]), ([], ["f64", "f64"]),
              (["ts", "id"], ["id"])]
    for n in (1 << 16, 1 << 19):
        for preds, aggs in shapes:
            r = SC.run_case(SC.k2_case(n, preds, aggs, seed=1, dev=dev),
                            iters=20)
            print(json.dumps({k: r[k] for k in ("label", "ok", "ms",
                                                 "call_ms", "bound_ms")}))
            if not r["ok"]:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
