#!/usr/bin/env python3
"""Stacked K2's second design (``rows_agg_kernel``) at ``selfcheck.
rung_cases``' shape (R = 4, n = 2**19, K = 1, M = 2, one float64 sum)
built from patched copies of its source under build/probes
(``patched.py``): whole; without the float64 min / max partial of each
logical block (``no_minmax``); as a bare stream of its items through the
ring (``stream``: no predicate, aggregate, mask store, window, minmax,
group or tail work, each item's first values kept so that nothing is
compiled away); with a ring of 2 or 6 slots (``ring2``, ``ring6``: six
no longer leave room for two blocks an SM); and with a ring of 8 and
one block an SM (``one_block``).  The variants' results are wrong by
design (but ``whole``'s, the rings' and ``one_block``'s); only their
times are read.  One JSON line a variant: the
device µs of each launch by name and their span
(``time_model_kernels.split_us``, L2 write-flushed before each call).

Usage:  python scripts/probes/k2s_parts.py [--iters 50] [--only a,b]
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

FA = "filter_aggregate.cu"
NO_MINMAX = {FA: [(
    "      if (nf > 0) {\n        const int mb = (b - b0) % NBUF;",
    "      if (false) {\n        const int mb = (b - b0) % NBUF;")]}
STREAM_ONLY = {FA: [
    ("            mask &= pred_bits(p.c[col], pr, s_lo[col], s_hi[col]);\n",
     "            mask &= pr.v[0] ^ static_cast<uint32_t>(pr.x[0]);\n"),
    ("        store_mask(ra.mask, roff + lbase, roff + n, whole, mask);\n",
     ""),
    ("          agg_run(a.c[j], ar, mask, acc[j]);\n",
     "          acc[j][0] += ar.v[0] ^ ar.x[0] ^ mask;\n")]}


def ring(slots: int) -> dict:
    return {FA: [("#define RING 4 ", f"#define RING {slots} ")]}


ONE_BLOCK = {FA: [("#define RING 4 ", "#define RING 8 "),
                  ("#define ROWS_BPS 2 ", "#define ROWS_BPS 1 ")]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import selfcheck as SC
    from time_model_kernels import split_us
    from patched import (CSRC, K2S_NO_GROUPS, K2S_NO_TAIL, K2S_NO_WINDOWS,
                         merged, patched_csrc, use_csrc)
    if not torch.cuda.is_available():
        print("k2s_parts: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    variants = {
        "whole": None, "no_minmax": NO_MINMAX,
        "stream": merged(STREAM_ONLY, NO_MINMAX, K2S_NO_WINDOWS,
                         K2S_NO_GROUPS, K2S_NO_TAIL),
        "ring2": ring(2), "ring6": ring(6), "one_block": ONE_BLOCK}
    only = [v for v in args.only.split(",") if v] or list(variants)
    for name in only:
        patches = variants[name]
        use_csrc(ops, CSRC if patches is None
                 else patched_csrc(f"k2s_{name}", patches))
        case = SC.k2_rows_case(4, 1 << 19, ["ts"], ["id", "f64n"], 35, dev)
        r = SC.run_case(case, iters=args.iters, timed=False)
        split = split_us(case["run"], args.iters)
        print(json.dumps({"variant": name, "label": case["label"],
                          "ok": r["ok"], "bound_ms": r["bound_ms"],
                          "split_us": split, "span_us": split.pop("span")}),
              flush=True)
    use_csrc(ops)
    return 0


if __name__ == "__main__":
    sys.exit(main())
