#!/usr/bin/env python3
"""Time kernels of the port at their main-path shapes on one CUDA device,
beside their bounds, for one or two source trees: K7 (rmsnorm), K8 (flash
attention) and K9 (LSM decode attention) at the serve path's shapes
(``selfcheck.serve_cases``), K7's and K8's backward at the train step's
(``selfcheck.train_cases``: [4096, 8192]; q [2, 2048, 64, 128], k/v
[2, 2048, 8, 128], causal, float32), K2 (fused filter-aggregate) at the
columnar path's n = 2**19 and K5 (edit distances) at the fuzzy path's
2**16 names
(``selfcheck.main_path_cases``), K4 (T-occurrence count) at T > 1: the
columnar T = 3 case, the 16-tier T = 13 case and the ngram probe's own
shape at T = 13 and 7 (built here for a tree that predates
``selfcheck.k4_path_case``), K3 (sorted intersect mask) at the LSM
merge's n = 2**18 union keys and m = 2**16 component keys, K6 (set
intersection counts) at the Jaccard select's 2**7 pairs of width 32 and
the wide-vocabulary FuzzyJoin's 2**17 pairs of width 67, K1 (range mask)
at the columnar path's n = 2**19 with K = 1 int64 column (the skip-index
select's timestamp range) and K = 2, and A7 (bitset intersection counts)
on the operands the two bitset FuzzyJoins of ``chip_smoke.py`` hand it
(the clustered records' and table 3's tags, found by running the join
with the wrapper replaced by a recorder), each with its live pairs and
with the pairs padded to a power of two (what a tree that counts the
padding launches), and on 2**18 pairs drawn uniformly (the earlier
runs' case), and rungs 3 and 4's A6 (fused index chain: its four
``selfcheck.rung_cases``, mask and aggregate mode at R = 1 and 4) and
stacked K2 (R = 4, n = 2**19, K = 1, M = 2), and the exchange
(``spmd_exchange``: grouped_topk's ~734,000 partial groups over 4
partitions, beside one stable ``torch.argsort`` and an ``index_select`` a
column region as its library yardstick).

Usage:  python scripts/time_model_kernels.py [--src DIR [--src DIR]]
            [--kernels rmsnorm,lsm_decode_attention,flash_attention,
                       rmsnorm_bwd,flash_attention_bwd,
                       fused_filter_aggregate,t_occurrence_mask,
                       edit_distances,sorted_intersect_mask,
                       set_intersect_counts,range_mask,
                       bitset_intersect_counts,fused_index_chain,
                       stacked_filter_aggregate,spmd_exchange] [--iters 50]

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
products.  Every case also prints ``split``: the device µs a call of each
kernel, memset and copy it runs, by name, and under ``span`` the union of
their device intervals, after the same write flush (``split_us``).  This
script computes ``split`` itself, so two trees are timed by one
definition even where their ``selfcheck`` modules define ``ms``
differently; trees that launch different work compare launch by launch.
Prints the card line, then one JSON object per (tree, run, case).
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
# holds "intersect": A7's kernel, bitset_intersect_kernel, holds it too but
# never runs in their cases)
KERNELS = {"rmsnorm": ("rmsnorm",), "lsm_decode_attention": ("decode_partial",),
           "flash_attention": ("flash_fwd_", "flash_wg_"),
           "rmsnorm_bwd": ("rmsnorm_bwd", "rmsnorm_dw"),
           "flash_attention_bwd": ("flash_bwd_",),
           "fused_filter_aggregate": ("agg_",),
           "t_occurrence_mask": ("tocc_", "Memset"),
           "edit_distances": ("edit_distance",),
           "sorted_intersect_mask": ("intersect",),
           "set_intersect_counts": ("intersect",),
           "range_mask": ("range_mask",),
           "bitset_intersect_counts": ("bitset_intersect",),
           "fused_index_chain": ("chain", "agg_", "Memset", "Memcpy"),
           "stacked_filter_aggregate": ("agg_",),
           "spmd_exchange": ("xch_", "exchange")}
SERVE = ("rmsnorm", "lsm_decode_attention", "flash_attention")
# the train step's backward kernels (selfcheck.train_cases)
TRAIN = ("rmsnorm_bwd", "flash_attention_bwd")
MAIN = ("fused_filter_aggregate", "edit_distances", "sorted_intersect_mask",
        "set_intersect_counts")
# the rung cases' selfcheck kernel names, by option
RUNG = {"fused_index_chain": "fused_index_chain",
        "stacked_filter_aggregate": "filter_aggregate_stacked",
        "spmd_exchange": "spmd_exchange"}


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


def k1_cases(SC, dev) -> list:
    """K1 at n = 2**19: the columnar path's one int64 column, and K = 2
    (main_path_cases' seed)."""
    return [SC.k1_case(1 << 19, ["ts"], 0, dev),
            SC.k1_case(1 << 19, ["ts", "id"], 0, dev)]


def join_operands(FO, which: str):
    """(uint32 [R, W] bits, ai, bi) as the FuzzyJoin of ``chip_smoke.py``
    named ``which`` ("clustered" or "tags") hands them to
    ``fuzzy_ops.bitset_intersect_counts``."""
    import numpy as np
    from repro_torch.data.dedup import FuzzyJoin
    if which == "clustered":
        sys.path.insert(0, str(ROOT))
        from chip_smoke import clustered_records
        recs, thr = clustered_records(3500, 800, 3), 0.5
    else:                       # table 3's tags: 1,500 messages' tag sets
        from repro_torch.configs.tinysocial import gen_messages
        recs = [(m["message-id"], set(m["tags"]))
                for m in gen_messages(1500, 200_000, 1)]
        thr = 0.6
    got, real = [], FO.bitset_intersect_counts

    def record(bits, ai, bi):
        got.append((bits, ai, bi))
        return np.zeros(len(ai), dtype=np.int64)
    FO.bitset_intersect_counts = record
    try:
        FuzzyJoin(threshold=thr).run(recs)
    finally:
        FO.bitset_intersect_counts = real
    return got[-1]


def a7_cases(SC, FO, dev) -> list:
    """A7 on the two bitset joins' operands, live and padded pairs (rows
    padded to a power of two, as the pool pads them), and on 2**18 pairs
    drawn uniformly over 4,096 x 32 words (main_path_cases' seed)."""
    import numpy as np
    import torch
    out = []
    for which in ("clustered", "tags"):
        bits, ai, bi = join_operands(FO, which)
        R, W = bits.shape
        P = int(ai.shape[0])
        rp, pp = 1 << (R - 1).bit_length(), 1 << (P - 1).bit_length()
        words = np.zeros((rp, W), dtype=np.uint32)
        words[:R] = bits
        bt = torch.from_numpy(words.view(np.int32)).to(dev)
        idx = [np.zeros(pp, dtype=np.int64) for _ in range(2)]
        idx[0][:P], idx[1][:P] = ai, bi
        at, ct = (torch.from_numpy(x).to(dev) for x in idx)
        for n_pairs, tag in ((P, "live"), (pp, "padded")):
            a, c = at[:n_pairs], ct[:n_pairs]
            out.append({
                "kernel": "bitset_intersect_counts",
                "label": f"{which} join R={rp} W={W} P={P} {tag} "
                         f"({n_pairs} pairs)",
                "run": lambda a=a, c=c, b=bt: FO.popcount_cuda(b, a, c),
                "plain": lambda a=a, c=c, b=bt: FO.popcount_plain(b, a, c),
                "library": None, "compare": SC._mask_compare,
                "bytes": 4 * W * SC.rows_touched(idx[0][:n_pairs],
                                                 idx[1][:n_pairs])
                         + 24 * n_pairs, "ops": 3 * W * n_pairs})
    out.append(SC.a7_case(1 << 12, 32, 1 << 18, 60 / 800, 8, dev))
    return out


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


def union_us(spans: list) -> float:
    """Length of the union of [start, end) spans: launches that overlap
    on the device (a programmatic dependent launch starts before the one
    it depends on ends) count once, and gaps between them not at all."""
    total, cur = 0.0, None
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def split_us(fn, iters: int) -> dict:
    """Device µs a call of each kernel, memset and copy ``fn`` runs, by
    name (a kernel's name without its arguments), and under ``span`` the
    union of their spans (``union_us``), each call after the repository's
    write flush of L2 (``selfcheck._flush``, a fill kernel, left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import selfcheck
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            selfcheck._flush()
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "FillFunctor" in e.name:
            continue
        name = e.name.split("(")[0].replace("void ", "").strip()
        out[name] = out.get(name, 0.0) + e.device_time_total / iters
        spans.append((e.time_range.start, e.time_range.end))
    out["span"] = union_us(spans) / iters
    return out


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
    if any(k in TRAIN for k in kernels):
        cases += selfcheck.train_cases(dev)
    if any(k in MAIN for k in kernels):
        cases += [c for c in selfcheck.main_path_cases(dev)
                  if c["kernel"] in MAIN]
    if "t_occurrence_mask" in kernels:
        cases += k4_cases(selfcheck, fuzzy_ops, dev)
    if "range_mask" in kernels:
        cases += k1_cases(selfcheck, dev)
    if "bitset_intersect_counts" in kernels:
        cases += a7_cases(selfcheck, fuzzy_ops, dev)
    rung = {RUNG[k]: k for k in kernels if k in RUNG}
    if rung:
        cases += [c for c in selfcheck.rung_cases(dev)
                  if c["kernel"] in rung]
    for case in cases:
        opt = rung.get(case["kernel"], case["kernel"])
        if opt not in kernels:
            continue
        r = selfcheck.run_case(case, iters=iters)
        r.update(tree=src, run=run,
                 ms_clean=clean_ms(case["run"], KERNELS[opt], iters))
        r["split"] = split_us(case["run"], iters)
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
