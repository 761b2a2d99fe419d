#!/usr/bin/env python3
"""K8's float32 backward against its plain version (autograd of the
oracle on the card) at hd 128, causal, for Sq = Skv = 512, 1024 and 2048
with the train step's heads (H 64, KV 8) and with one KV head (H 8):
each gradient's largest error over its largest magnitude, where it lies,
and whether a second launch gives the same bits.  A drift that grows with
the sequence (the number of tiles summed into one accumulator) shows
here before the train shape's ``BWD_RTOL`` check fails.

Usage:  python scripts/probes/k8_bwd_drift.py
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))


def main() -> int:
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.kernels import selfcheck as SC
    if not torch.cuda.is_available():
        print("k8_bwd_drift: no CUDA device", file=sys.stderr)
        return 2
    repro_torch.set_device("cuda")
    dev = torch.device("cuda", 0)
    for B, H, KV, S in ((1, 64, 8, 512), (1, 64, 8, 1024), (2, 64, 8, 2048),
                        (1, 8, 1, 2048)):
        case = SC.k8_bwd_case(B, H, KV, S, S, 128, seed=31, dev=dev)
        got = case["run"]()
        torch.cuda.synchronize()
        again = case["run"]()
        torch.cuda.synchronize()
        ref = case["plain"]()
        for name, g, a, r in zip(("dq", "dk", "dv"), got, again, ref):
            e = (g - r).abs()
            top = float(r.abs().max())
            print(json.dumps({
                "shape": [B, H, KV, S], "grad": name,
                "max_abs_err": float(e.max()), "max_abs_ref": top,
                "rel": float(e.max()) / max(1.0, top),
                "at": [int(i) for i in np.unravel_index(int(e.argmax()),
                                                        e.shape)],
                "same_bits": bool(torch.equal(g, a))}), flush=True)
        del got, again, ref, case
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
