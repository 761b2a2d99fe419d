#!/usr/bin/env python3
"""K2 (fused filter-aggregate) at the columnar path's shape (n = 2**19,
K = 2, M = 2 with one float64 sum) built three ways: whole, without the
per-iteration staging of float64 windows, and without the last block's
fold of the node sums (patched copies of the sources under build/probes,
``patched.K2_NO_TREE`` and ``K2_NO_TAIL``): what the reference's float64
sum order costs, and where.  The variants' sums are wrong by design; only
their times are read.  One JSON line each (``selfcheck.run_case``: L2
write-flushed device ms).

Usage:  python scripts/probes/k2_parts.py   (from the repository root)
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main() -> int:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import selfcheck as SC
    if not torch.cuda.is_available():
        print("k2_parts: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from patched import (CSRC, K2_NO_TAIL, K2_NO_TREE, merged,
                         patched_csrc, use_csrc)
    for name, patches in (("whole", None), ("no_tree", K2_NO_TREE),
                          ("no_tail", K2_NO_TAIL),
                          ("neither", merged(K2_NO_TREE, K2_NO_TAIL))):
        use_csrc(ops, CSRC if patches is None
                 else patched_csrc(f"k2_{name}", patches))
        r = SC.run_case(SC.k2_case(1 << 19, ["ts", "id"], ["id", "f64"],
                                   seed=1, dev=dev), iters=50)
        print(json.dumps({"variant": name, **{k: r[k] for k in (
            "label", "ms", "call_ms", "bound_ms")}}), flush=True)
    use_csrc(ops)
    return 0


if __name__ == "__main__":
    sys.exit(main())
