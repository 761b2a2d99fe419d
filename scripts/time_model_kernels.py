#!/usr/bin/env python3
"""Time kernels of the port at their main-path shapes on one CUDA device,
beside their bounds, for one or two source trees: K7 (rmsnorm), K8 (flash
attention) and K9 (LSM decode attention) at the serve path's shapes
(``selfcheck.serve_cases``), K2 (fused filter-aggregate) at the columnar
path's n = 2**19 and K5 (edit distances) at the fuzzy path's 2**16 names
(``selfcheck.main_path_cases``), K4 (T-occurrence count) at T > 1: the
columnar T = 3 case, the 16-tier T = 13 case and the ngram probe's own
shape at T = 13 and 7 (built here for a tree that predates
``selfcheck.k4_path_case``), K3 (sorted intersect mask) at the LSM
merge's n = 2**18 union keys and m = 2**16 component keys, and K6 (set
intersection counts) at the Jaccard select's 2**7 pairs of width 32 and
the wide-vocabulary FuzzyJoin's 2**17 pairs of width 67.

Usage:  python scripts/time_model_kernels.py [--src DIR [--src DIR]]
            [--kernels rmsnorm,lsm_decode_attention,flash_attention,
                       fused_filter_aggregate,t_occurrence_mask,
                       edit_distances,sorted_intersect_mask,
                       set_intersect_counts] [--iters 50]

Each ``--src`` is a directory holding a ``repro_torch`` package (the
default is this checkout's ``src``).  Every tree runs in a process of its
own, which builds its own kernel library; two trees run in turns, A B B A,
so they are compared on one card in one call.  Each case is checked
against its plain version and timed two ways, the L2 cold both times:
``ms``, ``selfcheck.run_case``'s device time after a flush that WRITES
256 MB (the repository's kernel timing: the call then also pays for
writing back the ~50 MB of dirty lines the flush leaves in L2), and
``ms_clean``, the device time of the kernel's own launches (found by name
in the profiler's trace) after a flush that only READS 256 MB, which
leaves L2 clean, as a decode step finds it after the weight-reading
products.  Prints the card line, then one JSON object per (tree, run,
case).
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# selfcheck kernel name -> substrings of the names of its device work (K4's
# scatter route also clears its count array; every K3 and K6 kernel's name
# holds "intersect", and A7's never runs in their cases)
KERNELS = {"rmsnorm": ("rmsnorm",), "lsm_decode_attention": ("decode_partial",),
           "flash_attention": ("flash_",), "fused_filter_aggregate": ("agg_",),
           "t_occurrence_mask": ("tocc_", "Memset"),
           "edit_distances": ("edit_distance",),
           "sorted_intersect_mask": ("intersect",),
           "set_intersect_counts": ("intersect",)}
SERVE = ("rmsnorm", "lsm_decode_attention", "flash_attention")
MAIN = ("fused_filter_aggregate", "edit_distances", "sorted_intersect_mask",
        "set_intersect_counts")


def k4_cases(SC, FO, dev) -> list:
    """K4 at T > 1: the columnar T = 3 case (scatter in every tree), the
    16-tier T = 13 case (marked sorted where the tree takes the flag) and
    the ngram probe's shape at d = 1 and 3, with main_path_cases' seeds."""
    kw = {"sorted_": True} \
        if "sorted_" in inspect.signature(SC.k4_case).parameters else {}
    out = [SC.k4_case(1 << 19, 1 << 19, 3, 4, dev),
           SC.k4_case(1 << 16, 1 << 20, 13, 9, dev, tiers=16, **kw)]
    for d in (1, 3):
        out.append(SC.k4_path_case(d, 5, dev) if hasattr(SC, "k4_path_case")
                   else k4_path_tuples(SC, FO, d, 5, dev))
    return out


def k4_path_tuples(SC, FO, d: int, seed: int, dev) -> dict:
    """``selfcheck.k4_path_case`` for a tree whose K4 wrapper takes
    (positions, start, count, offset) tuples."""
    import numpy as np
    import torch
    from repro_torch.fuzzy.ngram import GRAM_K, GramPostings, query_grams
    rng = np.random.default_rng(seed)
    names = [f"User Number {i}"
             for i in rng.choice(200_000, 50_000, replace=False)]
    post = GramPostings.from_values(names, GRAM_K)
    qh, T = query_grams(("name", "ed", "User Number 123", d), GRAM_K)
    pos = torch.from_numpy(post.positions).to(dev)
    segs = [(pos, s.start, s.stop - s.start, s.offset)
            for s in post.hit_segments(qh, 0)]
    n, n_out = 50_000, 1 << 16
    flat = torch.cat([t[a:a + c] + off for t, a, c, off in segs])
    m = int(flat.shape[0])
    return {"kernel": "t_occurrence_mask",
            "label": f"ngram d={d} n={n} m={m} segments={len(segs)} T={T}",
            "run": lambda: FO.tocc_cuda(segs, n, n_out, T),
            "plain": lambda: FO.tocc_plain(segs, n, n_out, T),
            "library": lambda: torch.bincount(flat, minlength=n) >= T,
            "compare": SC._mask_compare, "bytes": 8 * m + n_out, "ops": m}


def clean_ms(fn, names: tuple, iters: int) -> float:
    """Device ms a call of the work whose names contain one of ``names``,
    each call after a read-only sweep of 256 MB."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sweep = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            sweep.sum()
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if any(k in e.name for k in names))
    return us / 1e3 / iters


def one(src: str, run: int, iters: int, kernels: list) -> int:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import fuzzy_ops, ops, selfcheck
    if not torch.cuda.is_available():
        print("time_model_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lib = ops.lib()
    occ = {}
    if hasattr(lib, "rt_decode_partial_clusters"):
        f = lib.rt_decode_partial_clusters
        f.restype = ctypes.c_int
        for dt, name in ((0, "float32"), (1, "bfloat16")):
            for c in (1, 8):
                out = ctypes.c_int(0)
                rc = f(dt, 128, 8, c, ctypes.byref(out))
                occ[f"{name} C={c}"] = out.value if rc == 0 else f"error {rc}"
    cases = selfcheck.serve_cases(dev) \
        if any(k in SERVE for k in kernels) else []
    if any(k in MAIN for k in kernels):
        cases += [c for c in selfcheck.main_path_cases(dev)
                  if c["kernel"] in MAIN]
    if "t_occurrence_mask" in kernels:
        cases += k4_cases(selfcheck, fuzzy_ops, dev)
    for case in cases:
        if case["kernel"] not in kernels:
            continue
        r = selfcheck.run_case(case, iters=iters)
        r.update(tree=src, run=run,
                 ms_clean=clean_ms(case["run"], KERNELS[case["kernel"]],
                                   iters))
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            return 1
    if occ:
        print(json.dumps({"tree": src, "run": run,
                          "max_active_clusters_G8_hd128": occ}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated selfcheck kernel names")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}; known: {list(KERNELS)}")
    if args.one:
        return one(args.one, args.run, args.iters, kernels)
    srcs = [str(Path(s).resolve()) for s in (args.src or [ROOT / "src"])]
    order = srcs if len(srcs) == 1 else [srcs[0], srcs[1], srcs[1], srcs[0]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    for i, src in enumerate(order):
        rc = subprocess.run([sys.executable, __file__, "--one", src,
                             "--run", str(i), "--iters", str(args.iters),
                             "--kernels", args.kernels]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
