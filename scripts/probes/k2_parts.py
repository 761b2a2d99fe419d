#!/usr/bin/env python3
"""K2 (fused filter-aggregate) at the columnar path's shape (n = 2**19,
K = 2, M = 2 with one float64 sum) built three ways: whole, without the
per-iteration staging of float64 windows (``-DK2_PROBE_NO_TREE``), and
without the last block's fold of the node sums (``-DK2_PROBE_NO_TAIL``):
what the reference's float64 sum order costs, and where.  The variants'
sums are wrong by design; only their times are read.  One JSON line each
(``selfcheck.run_case``: L2 write-flushed device ms).

Usage:  python scripts/probes/k2_parts.py   (from the repository root)
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))


def main() -> int:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import selfcheck as SC
    if not torch.cuda.is_available():
        print("k2_parts: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    base = list(ops.NVCC_FLAGS)
    for name, flags in (("whole", []), ("no_tree", ["-DK2_PROBE_NO_TREE"]),
                        ("no_tail", ["-DK2_PROBE_NO_TAIL"]),
                        ("neither", ["-DK2_PROBE_NO_TREE",
                                     "-DK2_PROBE_NO_TAIL"])):
        ops.NVCC_FLAGS[:] = base + flags
        ops._LIB[0] = None
        ops.lib()
        r = SC.run_case(SC.k2_case(1 << 19, ["ts", "id"], ["id", "f64"],
                                   seed=1, dev=dev), iters=50)
        print(json.dumps({"variant": name, **{k: r[k] for k in (
            "label", "ms", "call_ms", "bound_ms")}}), flush=True)
    ops.NVCC_FLAGS[:] = base
    ops._LIB[0] = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
