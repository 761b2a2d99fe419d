#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Drives the port's columnar and fuzzy query paths and its model serving
path on one CUDA device and checks them:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    the CUDA kernels from src/repro_torch/kernels/csrc
  3. kernels  K1-K9, A7 and rungs 3 and 4's kernels (A6, stacked K1 and
              K2, the exchange, a merge) against their plain PyTorch
              versions at main-path shapes (the serve phase's too), and
              K2, stacked K2 and A6 with 9 and 17 predicate columns, timed
              beside their bound and, where one PyTorch call computes the
              same function, that call
  4. main     TinySocial ingested through ``insert_batch`` (tiered merges
              run K3), then the table-3 query classes through
              ``run_query(..., vectorize=True)`` on the per-operator path
              (plan cache off: the index probes launch K4), cold and warm,
              checked against the row engine and numpy over the generated
              records
  4a. rung 3  the plan cache on: the index range scan (A6 in mask mode)
              and ``index_chain_aggregate_exact`` (A6 in aggregate mode),
              checked against the per-operator rows and numpy; warm runs
              ship nothing, retrace nothing and hit the plan cache
  4b. rung 4  ``mesh=4`` (lanes == partitions): the two chains (stacked
              A6), the skip-index select (stacked K1), the exact-range
              aggregate (stacked K2) and grouped_topk (the exchange: its
              partitions built on the card, the key hashed there), one
              stacked dispatch each, checked against the loop's rows; the
              partitions' partial aggregates merged (the merges) and
              checked against numpy
  4c. fuzzy   on the same users: an ngram(3) index on ``name`` and a
              keyword index on ``alias`` built by backfill, three fuzzy
              selects (K4 at T > 1, K5, K6) and a fuzzy keyword probe
              (K5, K4) cold and warm, checked against the row engine's
              full scan; ``FuzzyJoin.run`` on table 3's message tags and
              on clustered records (A7, and K6 past a 2**15 vocabulary),
              checked against the per-pair verify loop
  4d. feeds   the serving harness (``repro_torch.serve``): 4 feeds
              ingesting 1,000,000 records through ``insert_batch`` (K3
              merges) into 4 partitions with an index on val, 4 harness
              query workers, and 2 threads running an index range select
              (A6 with the plan cache on, K4 with it off), an exact
              skip-index aggregate (K2) and a skip-index select (K1) over
              pinned snapshots, each checked against numpy; a checkpoint
              and a crash with replay on the way; zero torn reads and lost
              acks, one recovery and the exact final key set checked
  4e. serve   deepseek-67b at its published widths, depth cut to 8 layers,
              float32 weights from a seeded generator: 8 requests of 512
              prompt tokens through one prefill (K7, K8), then 319 greedy
              decode steps on the flat cache and, fed the same tokens, on
              the LSM-tiered cache (K7, K9); checks prefill-decode
              consistency, flat against tiered logits at every step, the
              LSM counters and the launch counts
  4f. train   deepseek-67b at its published widths, depth cut to 2 layers,
              float32: ``Trainer`` takes 6 AdamW steps on one repeated
              global batch of 2 x 2048 tokens (remat "full": K7 and K8
              forward, their backward kernels); checks the loss falls and
              stays finite, each step's launch counts, that no plain
              version runs, and one more step's gradients against the
              same step through the plain versions on the card; profiles
              a step; then crash and resume at reduced widths (a
              checkpoint every 2 steps, a crash at step 4 of 6), whose
              losses must equal the uninterrupted run's bit for bit
  5. a ``kernels`` JSON line (K7-bwd and K8-bwd at the train step's
     shapes beside autograd's backward of F.rms_norm and of
     scaled_dot_product_attention; K7 and K9 with the cluster size each serve
     shape launched with, K8 with its float32 non-tensor bound beside the
     tensor-core one, K4's launches split by threshold and route, T > 1
     on the fuzzy path all by its sorted row-tile kernel, and K6's by
     caller),
     the card line, and the ``ok`` JSON line last

Usage:  python3 chip_smoke.py [--messages 2000000] [--users 200000]
                              [--partitions 4] [--flush-threshold 65536]
Any failed check raises and the script exits non-zero without the ``ok``
line; with no CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS's fixed workspace, which torch.use_deterministic_algorithms asks
# for (phase 4f's crash and resume); read when cuBLAS starts, so set
# before the first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("check failed: " + msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the table-3 query classes (benchmarks/table3_queries.py)
# ---------------------------------------------------------------------------

LO, HI = dt.datetime(2010, 1, 1), dt.datetime(2010, 2, 1)
MLO, MHI = dt.datetime(2014, 2, 1), dt.datetime(2015, 1, 1)
SKIP_HI = dt.datetime(2014, 2, 20)
JLO, JHI = dt.datetime(2014, 1, 1), dt.datetime(2014, 1, 4)


def plans(A):
    sel_j = A.select(A.scan("MugshotMessages"),
                     pred=lambda r: r["timestamp"] <= JHI,
                     fields=["timestamp"], ranges={"timestamp": (JLO, JHI)})
    return {
        "index_range_scan": A.select(
            A.scan("MugshotUsers"),
            pred=lambda r: LO <= r["user-since"] <= HI,
            fields=["user-since"], ranges={"user-since": (LO, HI)}),
        "exact_range_aggregate": A.aggregate(
            A.select(A.scan("MugshotMessages"),
                     pred=lambda r: r["timestamp"] >= MLO,
                     fields=["timestamp"], ranges={"timestamp": (MLO, MHI)},
                     ranges_exact=True, hints=["skip-index"]),
            {"cnt": ("count", "*"), "avg_author": ("avg", "author-id")}),
        "skip_index_select": A.select(
            A.scan("MugshotMessages"),
            pred=lambda r: MLO <= r["timestamp"] <= SKIP_HI,
            fields=["timestamp"], ranges={"timestamp": (MLO, SKIP_HI)},
            hints=["skip-index"]),
        "index_chain_aggregate": A.aggregate(
            A.select(A.scan("MugshotMessages"),
                     pred=lambda r: r["timestamp"] >= MLO,
                     fields=["timestamp"], ranges={"timestamp": (MLO, MHI)}),
            {"cnt": ("count", "*"), "avg_author": ("avg", "author-id")}),
        "grouped_topk": A.limit(A.order_by(
            A.group_by(A.scan("MugshotMessages"), ["author-id"],
                       {"cnt": ("count", "*")}), ["cnt"], desc=True), 10),
        "select_join": A.project(
            A.join(sel_j, A.scan("MugshotUsers"), ["author-id"], ["id"]),
            ["message-id", "author-id", "name"]),
    }


def rung_plans(A):
    """The rung-3 and rung-4 queries: the index range scan, and
    index_chain_aggregate with an exact range and no skip-index hint (the
    aggregate the fused chain reduces on the card), then, for the mesh,
    the skip-index select, the exact-range aggregate and grouped_topk."""
    base = plans(A)
    chain_agg = A.aggregate(
        A.select(A.scan("MugshotMessages"),
                 pred=lambda r: MLO <= r["timestamp"] <= MHI,
                 fields=["timestamp"], ranges={"timestamp": (MLO, MHI)},
                 ranges_exact=True),
        {"cnt": ("count", "*"), "avg_author": ("avg", "author-id")})
    rung3 = {"index_range_scan": base["index_range_scan"],
             "index_chain_aggregate_exact": chain_agg}
    rung4 = dict(rung3)
    for name in ("skip_index_select", "exact_range_aggregate",
                 "grouped_topk"):
        rung4[name] = base[name]
    return rung3, rung4


# the kernel each rung-4 query's one stacked dispatch launches
RUNG4_KERNEL = {"index_range_scan": "fused_index_chain",
                "index_chain_aggregate_exact": "fused_index_chain",
                "skip_index_select": "range_mask_stacked",
                "exact_range_aggregate": "filter_aggregate_stacked",
                "grouped_topk": "spmd_exchange"}
RUNG3_PATH = ("fused_index_chain",)
RUNG4_PATH = ("fused_index_chain", "range_mask_stacked",
              "filter_aggregate_stacked", "spmd_exchange", "spmd_merge")
EXCHANGE_H2D = "kernel.spmd_exchange.h2d_bytes"
HOST_PIDS = "mesh.exchange_host_pids"
MESH_LANES = 4


# a plan whose select is not ranges_exact re-checks its index survivors
# row by row and aggregates the gathered batch: those columns are new
# per query and ship (as in the reference, whose fused chain declines it)
GATHERED = {"index_chain_aggregate"}
WARM_REPEATS = 3
K2_H2D = "kernel.fused_filter_aggregate.h2d_bytes"
# the kernels each path must launch
COLUMNAR_PATH = ("range_mask", "fused_filter_aggregate",
                 "sorted_intersect_mask", "t_occurrence_mask")
FUZZY_PATH = ("t_occurrence_mask", "edit_distances", "set_intersect_counts",
              "bitset_intersect_counts")
SERVE_PATH = ("rmsnorm", "flash_attention", "lsm_decode_attention")


def canon(rows):
    return sorted(repr(sorted(r.items())) for r in rows)


def numpy_oracle(name, rows, rec):
    """Check one query's rows against numpy over the generated records."""
    import numpy as np
    ts, author, mid = rec["ts"], rec["author"], rec["mid"]
    if name == "index_range_scan":
        want = rec["uid"][(rec["since"] >= np.datetime64(LO))
                          & (rec["since"] <= np.datetime64(HI))]
        check(sorted(r["id"] for r in rows) == sorted(want.tolist()), name)
    elif name in ("exact_range_aggregate", "index_chain_aggregate",
                  "index_chain_aggregate_exact"):
        sel = (ts >= np.datetime64(MLO)) & (ts <= np.datetime64(MHI))
        check(len(rows) == 1 and rows[0]["cnt"] == int(sel.sum()), name)
        want = float(author[sel].sum()) / int(sel.sum())
        got = rows[0]["avg_author"]
        check(abs(got - want) <= 1e-12 * abs(want), f"{name}: {got} {want}")
    elif name == "skip_index_select":
        sel = (ts >= np.datetime64(MLO)) & (ts <= np.datetime64(SKIP_HI))
        check(sorted(r["message-id"] for r in rows)
              == sorted(mid[sel].tolist()), name)
    elif name == "grouped_topk":
        counts = np.bincount(author)
        top = sorted(counts.tolist(), reverse=True)[:10]
        check([r["cnt"] for r in rows] == top, name)
        check(all(counts[r["author-id"]] == r["cnt"] for r in rows), name)
    elif name == "select_join":
        sel = (ts >= np.datetime64(JLO)) & (ts <= np.datetime64(JHI))
        check(sorted(r["message-id"] for r in rows)
              == sorted(mid[sel].tolist()), name)


def build_tinysocial(args, port):
    """TinySocial through ``insert_batch`` (the feed path): flushes at the
    threshold and tiered merges (K3) run during ingest."""
    import numpy as np
    adm, ts, dsm = port["adm"], port["ts"], port["dsm"]
    t0 = time.perf_counter()
    users = ts.gen_users(args.users, args.seed)
    msgs = ts.gen_messages(args.messages, args.users, args.seed + 1)
    t_gen = time.perf_counter() - t0
    rec = {"uid": np.array([u["id"] for u in users], np.int64),
           "since": np.array([u["user-since"] for u in users],
                             "datetime64[us]"),
           "mid": np.array([m["message-id"] for m in msgs], np.int64),
           "author": np.array([m["author-id"] for m in msgs], np.int64),
           "ts": np.array([m["timestamp"] for m in msgs], "datetime64[us]"),
           # table 3's fuzzy join input: 1,500 messages' tag sets
           "tags": [(m["message-id"], set(m["tags"])) for m in msgs[:1500]]}
    dv = adm.Dataverse("TinySocial")
    ut = dv.create_type(ts.user_type())
    mt = dv.create_type(ts.message_type())
    ds = {"MugshotUsers": dsm.PartitionedDataset(
              "MugshotUsers", ut, "id", args.partitions,
              args.flush_threshold),
          "MugshotMessages": dsm.PartitionedDataset(
              "MugshotMessages", mt, "message-id", args.partitions,
              args.flush_threshold)}
    ds["MugshotUsers"].create_index("user-since")
    ds["MugshotMessages"].create_index("timestamp")
    ds["MugshotMessages"].create_index("author-id")
    t1 = time.perf_counter()
    chunk = 100_000
    for name, records in (("MugshotUsers", users),
                          ("MugshotMessages", msgs)):
        for i in range(0, len(records), chunk):
            ds[name].insert_batch(records[i:i + chunk])
    import torch
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t1
    n_rec = len(users) + len(msgs)
    print(f"main: generated {len(users)} users + {len(msgs)} messages in "
          f"{t_gen:.3f} s; ingested in {t_ingest:.3f} s "
          f"({n_rec / t_ingest:.0f} records/s, host clock)")
    return ds, rec


# ---------------------------------------------------------------------------
# rungs 3 and 4 of the query path: the fused chain and the partition mesh
# ---------------------------------------------------------------------------

def _timed_runs(query, plan, ds, reps, **kw):
    """``reps`` runs of one query: [(host s to synchronize, rows, stats,
    obs snapshot before, obs snapshot after)]."""
    import torch
    from repro_torch import obs
    out = []
    for _ in range(reps):
        snap0 = obs.snapshot()
        t = time.perf_counter()
        rows, ex = query.run_query(plan, ds, vectorize=True, **kw)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t, rows, ex.stats, snap0,
                    obs.snapshot()))
    return out


def rung3_phase(ds, rec, loop_rows):
    """Phase 4a: the plan cache on, each chain through A6, checked against
    its per-operator rows ``loop_rows``."""
    from repro_torch.columnar import plancache
    from repro_torch.core import algebra
    from repro_torch.storage import query
    rung3, _ = rung_plans(algebra)
    plancache.set_enabled(True)
    for name, plan in rung3.items():
        runs = _timed_runs(query, plan, ds, 1 + WARM_REPEATS)
        cold = runs[0][2]
        for _t, rows, st, _s0, _s1 in runs[1:]:
            check(st.h2d_bytes == 0, f"rung 3 {name}: warm h2d "
                                     f"{st.h2d_bytes}")
            check(st.kernel_retraces == 0, f"rung 3 {name}: warm retraces")
            check(st.plan_cache_hits > 0 and st.plan_cache_misses == 0,
                  f"rung 3 {name}: warm plan cache hits "
                  f"{st.plan_cache_hits} misses {st.plan_cache_misses}")
            check(st.rows_fallback == 0, f"rung 3 {name}: row fallback")
        rows = runs[-1][1]
        check(canon(rows) == canon(loop_rows[name]),
              f"rung 3 {name}: rows differ from the per-operator path's")
        numpy_oracle(name, rows, rec)
        warm = sorted(r[0] for r in runs[1:])
        st = runs[-1][2]
        print(f"rung3 {name}: rows {len(rows)} cold_s {runs[0][0]} "
              f"warm_s_median {warm[len(warm) // 2]} (host clock to "
              f"synchronize; {WARM_REPEATS} warm runs) cold_h2d "
              f"{cold.h2d_bytes} warm_h2d {st.h2d_bytes} warm_d2h "
              f"{st.d2h_bytes} warm_dispatches {st.kernel_dispatches} "
              f"plan_cache hits {st.plan_cache_hits} misses "
              f"{st.plan_cache_misses} (cold misses "
              f"{cold.plan_cache_misses}); checked against the "
              f"per-operator rows and numpy")


def rung4_phase(ds, rec, loop_rows):
    """Phase 4b: ``mesh=4`` lanes, one stacked dispatch a query, then the
    partitions' partial aggregates merged."""
    import numpy as np
    from repro_torch.core import algebra
    from repro_torch.runtime import spmd
    from repro_torch.storage import query
    _, rung4 = rung_plans(algebra)
    for name, plan in rung4.items():
        runs = _timed_runs(query, plan, ds, 1 + WARM_REPEATS,
                           mesh=MESH_LANES)
        cold = runs[0][2]
        for _t, rows, st, s0, s1 in runs:
            check(st.spmd_dispatches == 1 and st.spmd_partitions
                  == MESH_LANES, f"rung 4 {name}: spmd dispatches "
                                 f"{st.spmd_dispatches} partitions "
                                 f"{st.spmd_partitions}")
            check(st.rows_fallback == 0, f"rung 4 {name}: row fallback")
        for _t, rows, st, s0, s1 in runs[1:]:
            # the exchange's send buffer is built per query (as the
            # reference's send planes are); nothing else ships
            exch = s1.get(EXCHANGE_H2D, 0) - s0.get(EXCHANGE_H2D, 0)
            check(st.h2d_bytes == exch, f"rung 4 {name}: warm h2d "
                                        f"{st.h2d_bytes} beyond the "
                                        f"exchange's {exch}")
            check(st.kernel_retraces == 0, f"rung 4 {name}: warm retraces")
            # grouped_topk's key (author-id, every row valid) is hashed
            # on the card, not by the host
            check(s1.get(HOST_PIDS, 0) == s0.get(HOST_PIDS, 0),
                  f"rung 4 {name}: the host computed partition ids")
        rows = runs[-1][1]
        check(canon(rows) == canon(loop_rows[name]),
              f"rung 4 {name}: rows differ from the loop's")
        numpy_oracle(name, rows, rec)
        warm = sorted(r[0] for r in runs[1:])
        st = runs[-1][2]
        print(f"rung4 {name}: mesh {MESH_LANES} lanes, rows {len(rows)} "
              f"cold_s {runs[0][0]} warm_s_median {warm[len(warm) // 2]} "
              f"(host clock to synchronize; {WARM_REPEATS} warm runs) "
              f"cold_h2d {cold.h2d_bytes} warm_h2d {st.h2d_bytes} "
              f"warm_d2h {st.d2h_bytes} warm_dispatches "
              f"{st.kernel_dispatches} spmd_dispatches "
              f"{st.spmd_dispatches} spmd_partitions {st.spmd_partitions} "
              f"({RUNG4_KERNEL[name]}); checked against the loop's rows "
              f"and numpy")
    # GLOBAL_AGG's merge of the partitions' partial aggregates
    msgs = ds["MugshotMessages"]
    parts_i, parts_m = [], []
    for i in range(msgs.num_partitions):
        b = msgs.scan_partition_batch(i, ["author-id"])
        col = b.columns["author-id"]
        x = col.data[:len(b)][col.valid[:len(b)]]
        parts_i.append([x.shape[0], int(x.sum()), int(x.min()),
                        int(x.max())])
        parts_m.append([float(x.mean())])
    parts_i = np.asarray(parts_i, np.int64)
    with spmd.use_partition_mesh(MESH_LANES):
        total = spmd.psum_merge(parts_i[:, :2])
        lo = spmd.pmin_merge(parts_i[:, 2:3])
        hi = spmd.pmax_merge(parts_i[:, 3:])
        mean_hi = spmd.pmax_merge(np.asarray(parts_m))
    a = rec["author"]
    check(total.tolist() == [a.shape[0], int(a.sum())]
          and lo.tolist() == [int(a.min())] and hi.tolist() == [int(a.max())]
          and mean_hi[0] == max(m[0] for m in parts_m),
          f"rung 4 merges: {total} {lo} {hi} {mean_hi}")
    print(f"rung4 merges: psum of the {msgs.num_partitions} partitions' "
          f"(count, sum) of author-id {total.tolist()}, pmin "
          f"{lo.tolist()}, pmax {hi.tolist()}, pmax of the float64 means "
          f"{mean_hi.tolist()}; checked against numpy")


# ---------------------------------------------------------------------------
# the fuzzy path (benchmarks/table3_queries.py:128-158, fuzzy_bench.py)
# ---------------------------------------------------------------------------

FUZZY_SELECTS = {
    "fuzzy_ed_select": ("name", "ed", "User Number 123", 1),
    "fuzzy_ed_wide": ("name", "ed", "User Number 123", 3),
    "fuzzy_jaccard_select": ("name", "jaccard", "User Number 12345", 0.8),
}
KEYWORD_PROBE = ("alias", "user12345", 1)
# the verify operands (candidate strings, gram sets) are new per query and
# ship, as in the reference; everything else stays resident
VERIFY_H2D = ("kernel.edit_distances.h2d_bytes",
              "kernel.set_intersect_counts.h2d_bytes")
K4_H2D = "kernel.t_occurrence_mask.h2d_bytes"


def fuzzy_plans(A, fn, fuzzy_predicate):
    """The fuzzy selects (pred is the spec's own predicate, so the plans
    declare it exact, as fuzzy_bench.py does) and the keyword probe."""
    out = {name: A.select(A.scan("MugshotUsers"),
                          pred=fuzzy_predicate(spec), fields=["name"],
                          fuzzy=spec, ranges_exact=True)
           for name, spec in FUZZY_SELECTS.items()}
    fld, tok, ed = KEYWORD_PROBE
    out["fuzzy_keyword_probe"] = A.select(
        A.scan("MugshotUsers"),
        pred=lambda r: fld in r and any(fn.edit_distance_check(t, tok, ed)
                                        for t in fn.word_tokens(r[fld])),
        fields=[fld], keyword=KEYWORD_PROBE)
    return out


def clustered_records(n_records, vocab_size, noise, seed=7):
    """fuzzy_bench.py's near-duplicate clusters (its ``_join_rows`` at
    ``vocab_size`` 800, ``noise`` 3): 100 records per cluster, each its
    cluster's 60 base tokens less 5 plus ``noise`` random tokens."""
    import random
    rng = random.Random(seed)
    vocab = [f"tok{i}" for i in range(vocab_size)]
    recs = []
    for _c in range(max(n_records // 100, 1)):
        base = rng.sample(vocab, 60)
        for _ in range(100):
            s = set(base)
            for t in rng.sample(base, 5):
                s.discard(t)
            s.update(rng.sample(vocab, noise))
            recs.append((len(recs), s))
    return recs


def fuzzy_phase(ds, rec):
    """Phase 4c: the fuzzy query path on the ingested users.  Returns
    K6's launches split by caller: the fuzzy selects and probe, and the
    FuzzyJoins."""
    import torch
    from repro_torch import obs
    from repro_torch.core import algebra, functions
    from repro_torch.core.rewriter import RewriteConfig
    from repro_torch.data.dedup import FuzzyJoin
    from repro_torch.fuzzy import fuzzy_predicate
    from repro_torch.kernels import columnar_ops, selfcheck
    from repro_torch.storage import query
    users = ds["MugshotUsers"]
    # the users fit in the memtables (50,000 a partition, under the flush
    # threshold); flush them, as a deployment holding them for long would
    # have, so the index creation below takes the backfill path
    t = time.perf_counter()
    for part in users.partitions:
        part.primary.flush()
    print(f"fuzzy: MugshotUsers memtables flushed in "
          f"{time.perf_counter() - t} s (host clock)")
    for fld, kind in (("name", "ngram"), ("alias", "keyword")):
        t = time.perf_counter()
        users.create_index(fld, kind=kind)
        print(f"fuzzy: {kind} index on MugshotUsers.{fld} backfilled in "
              f"{time.perf_counter() - t} s (host clock)")
    qs = fuzzy_plans(algebra, functions, fuzzy_predicate)
    for name, plan in qs.items():
        times = []
        for rep in range(1 + WARM_REPEATS):
            snap0 = obs.snapshot()
            t = time.perf_counter()
            rows, ex = query.run_query(plan, ds, vectorize=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            snap1 = obs.snapshot()
            st = ex.stats
            if rep == 0:
                cold = st
                continue
            check(st.kernel_retraces == 0, f"{name}: warm retraces")
            check(st.rows_fallback == 0, f"{name}: warm row fallback "
                                         f"{st.fallback_reasons}")
            if name in FUZZY_SELECTS:
                check(st.rows_fuzzy_vectorized > 0,
                      f"{name}: the fuzzy chain did not run")
            k4 = snap1.get(K4_H2D, 0) - snap0.get(K4_H2D, 0)
            check(k4 == 0, f"{name}: warm K4 positions shipped {k4} B")
            verify = sum(snap1.get(k, 0) - snap0.get(k, 0)
                         for k in VERIFY_H2D)
            check(st.h2d_bytes == verify,
                  f"{name}: warm h2d {st.h2d_bytes} beyond the verify "
                  f"operands' {verify}")
        check(cold.rows_fallback == 0, f"{name}: cold row fallback")
        t = time.perf_counter()
        srows, _ = query.run_query(
            plan, ds, config=RewriteConfig(use_indexes=False))
        t_scan = time.perf_counter() - t
        check(canon(srows) == canon(rows), f"{name}: row engine full scan")
        warm = sorted(times[1:])
        med = warm[len(warm) // 2]
        busy = selfcheck.device_ms(
            lambda: query.run_query(plan, ds, vectorize=True))
        if busy is None or (busy == 0 and st.kernel_dispatches):
            idle = "busy not measured: the profiler recorded no kernel"
        else:
            idle = f"busy_s {busy / 1e3}, idle share {1 - busy / 1e3 / med}"
        print(f"query {name}: rows {len(rows)} cold_s {times[0]} "
              f"warm_s_median {med} (host clock to synchronize; "
              f"{WARM_REPEATS} warm runs) warm device {idle} (profiler) "
              f"cold_h2d {cold.h2d_bytes} warm_h2d {st.h2d_bytes} "
              f"(verify operands; K4 0) warm_dispatches "
              f"{st.kernel_dispatches} rows_fuzzy_vectorized "
              f"{st.rows_fuzzy_vectorized} rows_index_vectorized "
              f"{st.rows_index_vectorized}; checked against the row "
              f"engine's full scan ({t_scan} s)")
    k6 = selfcheck.KERNELS["set_intersect_counts"]["wrapper"]
    k6_selects = k6.launches
    joins = {"table3_tags": (rec["tags"], 0.6),
             "clustered_bitset": (clustered_records(3500, 800, 3), 0.5),
             "clustered_wide_vocab": (clustered_records(3500, 1 << 20, 12),
                                      0.5)}
    for name, (recs, thr) in joins.items():
        fj = FuzzyJoin(threshold=thr)
        t = time.perf_counter()
        pairs, stats = fj.run(recs)
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t
        fj.batch_verify = False
        t = time.perf_counter()
        loop_pairs, _ = fj.run(recs)
        t_loop = time.perf_counter() - t
        check(pairs == loop_pairs, f"{name}: batched verify disagrees with "
                                   f"the per-pair loop")
        vocab = len(set().union(*(s for _, s in recs)))
        print(f"fuzzyjoin {name}: {stats} vocabulary {vocab} threshold "
              f"{thr}; run {t_batch} s batched, {t_loop} s with the "
              f"per-pair loop (host clock)")
    seen = sorted(k for k in columnar_ops._SEEN if k[0] in FUZZY_PATH)
    print(f"fuzzy: kernel shapes seen {seen}")
    return {"fuzzy_select": k6_selects,
            "fuzzy_join": k6.launches - k6_selects}


# ---------------------------------------------------------------------------
# the feeds phase: the serving harness ingesting through feeds while query
# threads run on the card (src/repro_torch/serve, src/repro_torch/data)
# ---------------------------------------------------------------------------

# 4 ingest lanes of 250,000 records (the harness's _default_record: val =
# pk * 2654435761 mod 100003), 4 partitions flushing at half TinySocial's
# 65,536 so flushes and K3 merges keep running while the queries run
FEEDS = {"partitions": 4, "flush_threshold": 32_768, "merge_k": 4,
         "n_ingest": 4, "n_query": 4, "pump_batch": 1024, "queue_depth": 8,
         "records_per_lane": 250_000, "checkpoint_at": 400_000,
         "crash_at": 700_000, "query_threads": 2, "limit_s": 600}
FEEDS_PATH = ("sorted_intersect_mask", "range_mask", "fused_filter_aggregate",
              "t_occurrence_mask", "fused_index_chain")
FEED_QUERIES = ("feed_index_range", "feed_range_aggregate",
                "feed_skip_select")
FEED_KINDS = ("feed_index_range (plan cache on)",
              "feed_index_range (plan cache off)", "feed_range_aggregate",
              "feed_skip_select")


def feed_plans(A, pk_lo):
    """The feeds phase's three queries: an index range select on val (~1%
    of the rows: A6, or K4 with the plan cache off), an exact skip-index
    aggregate on val (~10%: K2) and a skip-index select of 4,096
    consecutive pks (K1)."""
    return {
        "feed_index_range": A.select(
            A.scan("Feeds"), pred=lambda r: 0 <= r["val"] <= 999,
            fields=["val"], ranges={"val": (0, 999)}),
        "feed_range_aggregate": A.aggregate(
            A.select(A.scan("Feeds"), pred=lambda r: 0 <= r["val"] <= 9999,
                     fields=["val"], ranges={"val": (0, 9999)},
                     ranges_exact=True, hints=["skip-index"]),
            {"cnt": ("count", "*"), "avg_pk": ("avg", "pk")}),
        "feed_skip_select": A.select(
            A.scan("Feeds"), pred=lambda r: pk_lo <= r["pk"] <= pk_lo + 4095,
            fields=["pk"], ranges={"pk": (pk_lo, pk_lo + 4095)},
            hints=["skip-index"]),
    }


def feed_oracle(name, rows, pks, pk_lo):
    """Check one concurrent query's rows against numpy over the pks of the
    snapshot it ran on, val recomputed from pk."""
    import numpy as np
    val = (pks * 2654435761) % 100003
    if name == "feed_index_range":
        want = pks[val <= 999]
    elif name == "feed_skip_select":
        want = pks[(pks >= pk_lo) & (pks <= pk_lo + 4095)]
    else:
        sel = pks[val <= 9999]
        want_avg = int(sel.sum()) / sel.size if sel.size else None
        check(len(rows) == 1 and rows[0]["cnt"] == sel.size
              and rows[0]["avg_pk"] == want_avg,
              f"{name}: {rows} against count {sel.size} avg {want_avg}")
        return
    check(sorted(r["pk"] for r in rows) == sorted(want.tolist()),
          f"{name}: {len(rows)} rows against {want.size}")
    check(all(r["val"] == (r["pk"] * 2654435761) % 100003 for r in rows),
          f"{name}: a row's val is not its pk's")


def feeds_phase(seed, card, sizes=FEEDS):
    """Phase 4d: ``ServeHarness`` (4 ingest lanes through feeds, 4 query
    workers) on a ``PartitionedDataset`` with a B+-tree index on val,
    beside ``query_threads`` threads that pin a snapshot and run the feed
    queries through ``run_query(..., vectorize=True)``, each checked
    against numpy over that snapshot; the index selects run one at a time
    with the plan cache on and off in turn (A6, then K4).  Drives
    ``start()``, a ``checkpoint()``, a ``crash_and_recover()`` (no query
    thread runs across it) and ``stop()``.  A dead pump or sink, a query
    error or a wrong row fails the phase.  ``sizes``: ``FEEDS``, or
    smaller for a rehearsal on the CPU."""
    import threading
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.columnar import plancache
    from repro_torch.core import adm, algebra
    from repro_torch.core.lsm import TieredMergePolicy
    from repro_torch.serve import ServeHarness
    from repro_torch.storage.dataset import PartitionedDataset
    from repro_torch.storage.query import run_query
    z = sizes
    rt = adm.RecordType("R", (adm.Field("pk", adm.INT64),
                              adm.Field("val", adm.INT64)), open=True)
    ds = PartitionedDataset("Feeds", rt, "pk", z["partitions"],
                            z["flush_threshold"],
                            merge_policy=TieredMergePolicy(k=z["merge_k"]))
    ds.create_index("val")
    h = ServeHarness(ds, n_ingest=z["n_ingest"], n_query=z["n_query"],
                     pump_batch=z["pump_batch"], queue_depth=z["queue_depth"],
                     records_per_lane=z["records_per_lane"])
    total = z["n_ingest"] * z["records_per_lane"]
    deaths, errors = [], []
    done = threading.Event()
    # the query threads each hold a slot for a query; the crash clears
    # ``open_`` (no new query starts) and takes every slot
    slots = threading.Semaphore(z["query_threads"])
    open_ = threading.Event()
    open_.set()
    lat = {q: [] for q in FEED_QUERIES}
    ran = {}
    lock = threading.Lock()
    index_lock = threading.Lock()
    index_runs = [0]

    def query_loop(t):
        rng = np.random.default_rng(seed + t)
        i = t
        try:
            while not done.is_set():
                name = FEED_QUERIES[i % len(FEED_QUERIES)]
                i += 1
                open_.wait()
                with slots:
                    snap = ds.pin()
                    try:
                        pks = np.concatenate(
                            [snap.partition_pk_array(p)
                             for p in range(ds.num_partitions)]
                        ).astype(np.int64)
                        if not pks.size:       # nothing acked yet
                            i -= 1
                            continue
                        lo = int(rng.integers(0, max(1, int(pks.max(
                            initial=0)) - 4095)))
                        plan = feed_plans(algebra, lo)[name]
                        if name == "feed_index_range":
                            # the plan cache is global: one index select at
                            # a time, turns on and off (the other plans
                            # take no index)
                            with index_lock:
                                cache = index_runs[0] % 2 == 0
                                index_runs[0] += 1
                                plancache.set_enabled(cache)
                                t0 = time.perf_counter()
                                rows, _ = run_query(plan, {"Feeds": snap},
                                                    vectorize=True)
                                dt_s = time.perf_counter() - t0
                        else:
                            t0 = time.perf_counter()
                            rows, _ = run_query(plan, {"Feeds": snap},
                                                vectorize=True)
                            dt_s = time.perf_counter() - t0
                        feed_oracle(name, rows, pks, lo)
                    finally:
                        snap.release()
                key = name + (f" (plan cache {'on' if cache else 'off'})"
                              if name == "feed_index_range" else "")
                with lock:
                    lat[name].append(dt_s)
                    ran[key] = ran.get(key, 0) + 1
        except BaseException as e:       # noqa: BLE001
            errors.append(f"query thread {t}: {type(e).__name__}: {e}")

    def hook(a):
        deaths.append(f"{a.thread.name}: {a.exc_type.__name__}: "
                      f"{a.exc_value}")
    old_hook = threading.excepthook
    threading.excepthook = hook
    snap0 = obs.snapshot()
    t_start = time.perf_counter()
    plancache.set_enabled(True)
    queriers = [threading.Thread(target=query_loop, args=(t,),
                                 name=f"feed-query-{t}", daemon=True)
                for t in range(z["query_threads"])]
    try:
        h.start()
        for q in queriers:
            q.start()
        did_ckpt = did_crash = False
        marks = {}
        while True:
            check(not deaths, f"feeds: a worker thread died: {deaths}")
            check(not errors, f"feeds: {errors}")
            check(time.perf_counter() - t_start < z["limit_s"],
                  f"feeds: not done in {z['limit_s']} s")
            with h._ack_lock:
                acked = sum(len(a) for a in h.acked)
            if not did_ckpt and acked >= z["checkpoint_at"]:
                h.checkpoint()
                did_ckpt = True
                marks["checkpoint"] = (acked, time.perf_counter() - t_start)
            if did_ckpt and not did_crash and acked >= z["crash_at"]:
                open_.clear()
                for _ in range(z["query_threads"]):
                    slots.acquire()
                try:
                    h.crash_and_recover()
                finally:
                    for _ in range(z["query_threads"]):
                        slots.release()
                    open_.set()
                did_crash = True
                marks["crash"] = (acked, time.perf_counter() - t_start)
            with lock:
                kinds = sum(ran.get(k, 0) > 0 for k in FEED_KINDS)
            if did_crash and h.exhausted() and kinds == len(FEED_KINDS):
                break
            time.sleep(0.01)
        done.set()
        for q in queriers:
            q.join(timeout=120)
        check(not any(q.is_alive() for q in queriers),
              "feeds: a query thread did not stop")
        check(not deaths, f"feeds: a worker thread died: {deaths}")
        check(not errors, f"feeds: {errors}")
        h.stop()
    finally:
        done.set()
        open_.set()
        threading.excepthook = old_hook
        plancache.set_enabled(True)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    rep = h.report()
    check(not deaths, f"feeds: a worker thread died: {deaths}")
    check(rep.torn_reads == 0 and rep.lost_acks == 0
          and rep.lost_acked_final == 0,
          f"feeds: torn {rep.torn_reads} lost {rep.lost_acks} lost final "
          f"{rep.lost_acked_final}")
    check(not rep.query_errors, f"feeds: query errors {rep.query_errors}")
    check(rep.recoveries == 1, f"feeds: recoveries {rep.recoveries}")
    final = np.concatenate([ds.partition_pk_array(p)
                            for p in range(ds.num_partitions)])
    check(final.size == total and np.array_equal(np.sort(final),
                                                 np.arange(total)),
          f"feeds: the final pk set is not range({total})")
    check(all(ran.get(k, 0) > 0 for k in FEED_KINDS),
          f"feeds: a query never ran: {ran}")
    snap1 = obs.snapshot()

    def delta(k):
        return snap1.get(k, 0) - snap0.get(k, 0)

    def ms(xs, q):
        return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else None
    print(f"feeds: on {card}: {total} records through {z['n_ingest']} "
          f"feeds into "
          f"{z['partitions']} partitions (flush threshold "
          f"{z['flush_threshold']}, tiered k = {z['merge_k']}, an index on "
          f"val) beside {z['n_query']} harness query workers and "
          f"{z['query_threads']} query threads; phase {seconds} s (host "
          f"clock); checkpoint at {marks['checkpoint']} and crash at "
          f"{marks['crash']} (acked records, s)")
    print(f"feeds: ingest {rep.ingest_rate} records/s acked ({rep.ingest_acked} "
          f"distinct acked in {rep.duration_s} s); harness queries "
          f"{rep.queries}, p50 {rep.query_p50_ms} ms p99 "
          f"{rep.query_p99_ms} ms; phase p99 ms "
          f"{json.dumps(rep.phase_p99_ms)}; torn {rep.torn_reads} lost "
          f"{rep.lost_acks} lost final {rep.lost_acked_final} recoveries "
          f"{rep.recoveries}")
    print(f"feeds: concurrent queries {json.dumps(ran)}, every one "
          f"checked against numpy over its snapshot; latency ms (host "
          f"clock) " + "; ".join(
              f"{q} p50 {ms(v, 50)} p99 {ms(v, 99)}" for q, v in lat.items()))
    print(f"feeds: lsm flushes {delta('lsm.flushes')} merges "
          f"{delta('lsm.merges')}; final pk set range({total})")


# ---------------------------------------------------------------------------
# the model serving path (src/repro_torch/launch/serve.py)
# ---------------------------------------------------------------------------

SERVE = {"arch": "deepseek-67b", "layers": 8, "requests": 8, "prompt": 512,
         "gen": 320, "tail_cap": 64, "l1_comps": 4}
# Logits of two float32 routes through the same model: the prefill's
# 4,104-row products and K8 against the decode's 8-row products and K9,
# or one K9 component against L2 + L1 + tail merged.  cuBLAS and the
# kernels sum d = 8192 (and 22,016) terms in other orders on each route,
# a few 1e-7 relative per product, compounding over 8 layers to ~1e-5 of
# the largest logit; 1e-3 of it leaves 100x margin and still fails a
# wrong position, mask or cache row (errors of order 1e-1 and above).
LOGIT_RTOL = 1e-3


def _logit_err(got, want):
    import torch
    err = float((got - want).abs().max())
    return err, err <= LOGIT_RTOL * max(1.0, float(want.abs().max())) \
        and bool(torch.isfinite(got).all())


def serve_phase(seed):
    """Phase 4e; returns the launch counts of the main serve run (the
    prefill and both decode runs)."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import selfcheck
    from repro_torch.launch import serve
    c = SERVE
    L, B, P, T = c["layers"], c["requests"], c["prompt"], c["gen"]
    cfg = dataclasses.replace(
        serve.build_config(c["arch"], reduce=False, layers=L,
                           kv_layout="flat"),
        kv_tail_cap=c["tail_cap"], kv_l1_comps=c["l1_comps"])
    tiered = dataclasses.replace(cfg, kv_layout="tiered")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = serve.make_params(cfg, seed)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"serve: {cfg.name} d_model {cfg.d_model} heads {cfg.num_heads} "
          f"kv_heads {cfg.num_kv_heads} head_dim {cfg.resolved_head_dim} "
          f"d_ff {cfg.d_ff} vocab {cfg.vocab_size}, {L} of "
          f"{get_config(c['arch']).num_layers} layers: {n_params} "
          f"float32 parameters made on the card in "
          f"{time.perf_counter() - t} s; matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn TF32 "
          f"{torch.backends.cudnn.allow_tf32}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device="cuda")
    per_fwd = 2 * L + 1                     # norm1, norm2 a layer, final
    want = {"prefill": {"rmsnorm": per_fwd, "flash_attention": L,
                        "lsm_decode_attention": 0},
            "flat": {"rmsnorm": per_fwd * (T - 1), "flash_attention": 0,
                     "lsm_decode_attention": L * (T - 1)},
            "tiered": {"rmsnorm": per_fwd * (T - 1), "flash_attention": 0,
                       "lsm_decode_attention":
                       L * (2 + c["l1_comps"]) * (T - 1)}}
    total = dict.fromkeys(selfcheck.KERNELS, 0)

    def counted(name, fn):
        selfcheck.reset_launch_counts()
        out = fn()
        got = selfcheck.launch_counts()
        for k, n in want[name].items():
            check(got[k] == n, f"serve {name}: {k} launched {got[k]} "
                               f"times, expected {n}")
        for k, n in got.items():
            total[k] += n
        print(f"serve {name}: launches {json.dumps(got)} (as expected)")
        return out

    pre = counted("prefill", lambda: serve.prefill(params, cfg, prompts))
    logits0 = pre["logits"]
    check(tuple(logits0.shape) == (B, cfg.vocab_size)
          and bool(torch.isfinite(logits0).all()), "prefill logits")
    print(f"serve prefill: {B} x {P} tokens in {pre['seconds']} s, "
          f"{B * P / pre['seconds']} tokens/s (host clock to synchronize)")
    first = logits0.argmax(-1)[:, None]
    runs = {}
    for name, layout_cfg, forced in (("flat", cfg, None),
                                     ("tiered", tiered, "flat")):
        cache = serve.prepare_cache(layout_cfg, pre["cache"], P + T)
        ft = None if forced is None else runs[forced]["tokens"][:, 1:]
        runs[name] = counted(name, lambda: serve.decode(
            params, layout_cfg, cache, first, P, T - 1, forced=ft,
            keep_logits=True))
        r = runs[name]
        print(f"serve decode {name}: {B} x {T - 1} tokens in "
              f"{r['seconds']} s, {B * (T - 1) / r['seconds']} tokens/s "
              f"(host clock to synchronize)")
    # (d) the LSM counters after T - 1 tiered steps
    steps = T - 1
    flushes = (steps - 1) // c["tail_cap"]
    merges = flushes // c["l1_comps"]
    for i, st in enumerate(runs["tiered"]["cache"]):
        check((st["flushes"], st["merges"]) == (flushes, merges),
              f"tiered layer {i}: flushes {st['flushes']} merges "
              f"{st['merges']}, expected {flushes} and {merges}")
    print(f"serve tiered: flushes {flushes} merges {merges} in each of "
          f"{L} layers; L2 {runs['tiered']['cache'][0]['l2_len']} rows, "
          f"L1 {runs['tiered']['cache'][0]['l1_count']} slots, tail "
          f"{runs['tiered']['cache'][0]['tail_len']}")
    # (c) tiered logits against flat logits at every step
    worst = 0.0
    for t, (a, b) in enumerate(zip(runs["tiered"]["logits"],
                                   runs["flat"]["logits"])):
        err, ok = _logit_err(a, b)
        check(ok, f"tiered step {t}: logits differ from flat by {err}")
        worst = max(worst, err)
    print(f"serve: tiered logits equal flat logits at all {steps} steps, "
          f"max abs difference {worst} (bound {LOGIT_RTOL} x max |logit|)")
    # (b) decoding token P at pos P equals prefilling P + 1 tokens
    oracle = serve.prefill(params, cfg, torch.cat([prompts, first], 1))
    for name in ("flat", "tiered"):
        err, ok = _logit_err(runs[name]["logits"][0], oracle["logits"])
        check(ok, f"{name}: decode at pos {P} differs from a prefill of "
                  f"{P + 1} tokens by {err}")
        print(f"serve {name}: decode of token {P} equals the prefill of "
              f"{P + 1} tokens, max abs difference {err}")
    print(f"serve: peak device memory {torch.cuda.max_memory_allocated()} "
          f"B; generated tokens {runs['flat']['tokens'].shape}")
    # where a decode step's time goes: a few steps under the profiler
    for name, layout_cfg in (("flat", cfg), ("tiered", tiered)):
        cache = serve.prepare_cache(layout_cfg, pre["cache"], P + T)
        wall, busy, top = _profile_decode(serve, params, layout_cfg, cache,
                                          first, P, PROFILED_STEPS)
        if busy == 0:
            print(f"serve profile {name}: {PROFILED_STEPS} steps, per step "
                  f"{wall / PROFILED_STEPS} s host clock; device busy not "
                  f"measured: the profiler recorded no kernel")
            continue
        print(f"serve profile {name}: {PROFILED_STEPS} steps, per step "
              f"{wall / PROFILED_STEPS} s host clock (profiler on), device "
              f"busy {busy / PROFILED_STEPS} s, idle share "
              f"{1 - busy / wall}; top device time per step: "
              + "; ".join(f"{k[:70]} {us / PROFILED_STEPS / 1e3} ms x"
                          f"{n // PROFILED_STEPS}" for us, k, n in top[:6]))
        for kname, tag in (("K9", "decode_partial"), ("K7", "rmsnorm_")):
            mine = [(us, n) for us, k, n in top if tag in k]
            print(f"serve profile {name}: {kname} "
                  f"{sum(u for u, _ in mine) / PROFILED_STEPS / 1e3} ms a "
                  f"step over {sum(n for _, n in mine) // PROFILED_STEPS} "
                  f"launches")
    del params, pre, runs, oracle
    torch.cuda.empty_cache()
    return total


PROFILED_STEPS = 4


# ---------------------------------------------------------------------------
# the training path (src/repro_torch/training)
# ---------------------------------------------------------------------------

# deepseek-67b at its published widths, 2 of 95 layers (float32
# parameters, gradients and AdamW moments take 49 GB of the card's 80;
# 3 layers, 60 GB before activations, leave no margin), 2 x 2048 tokens a
# step; the crash-and-resume part at reduced widths (a full-width
# checkpoint would write ~37 GB a save)
TRAIN = {"arch": "deepseek-67b", "layers": 2, "batch": 2, "seq": 2048,
         "steps": 6, "crash_batch": 4, "crash_seq": 16}
TRAIN_PATH = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
              "flash_attention_bwd")
# Gradients of one step through the kernels against the same step through
# the plain versions (autograd of rmsnorm_ref and flash_attention_ref), on
# the card: both routes run the same cuBLAS products; K7's and K8's
# forward and backward sum in other orders than the plain versions (K8's
# forward in 3xTF32), ~1e-6 relative each, compounding through 2 layers
# and the 102,400-way softmax to ~1e-5 of a leaf's largest gradient.
# 1e-3 of it leaves 100x margin and still fails a wrong mask, a lost tile,
# a wrong head or a missing gradient (errors of order 1 of it).
GRAD_RTOL = 1e-3


class _OracleCalls:
    """Counts calls of the plain versions of K7 and K8 (forward and
    backward) made through any repro_torch module while it is active: on
    the card's training path there must be none."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import ref
        from repro_torch.kernels import rmsnorm as RN
        watched = {"flash_attention_ref": ref.flash_attention_ref,
                   "rmsnorm_ref": ref.rmsnorm_ref,
                   "flash_plain": FA.flash_plain,
                   "flash_bwd_plain": FA.flash_bwd_plain,
                   "rmsnorm_bwd_plain": RN.rmsnorm_bwd_plain}
        self.calls = dict.fromkeys(watched, 0)
        by_id = {id(f): (n, f) for n, f in watched.items()}
        self.patched = []
        for mod in list(sys.modules.values()):
            if not getattr(mod, "__name__", "").startswith("repro_torch"):
                continue
            for attr, val in list(vars(mod).items()):
                if id(val) in by_id:
                    name, f = by_id[id(val)]

                    def counted(*a, _n=name, _f=f, **k):
                        self.calls[_n] += 1
                        return _f(*a, **k)
                    setattr(mod, attr, counted)
                    self.patched.append((mod, attr, val))
        return self

    def __exit__(self, *exc):
        for mod, attr, val in self.patched:
            setattr(mod, attr, val)
        return False


def _repeat_adaptor(seq, vocab, seed, batch):
    """A synthetic token feed whose every global batch is the same
    ``batch`` documents (documents 0 .. batch - 1 over and over)."""
    from repro_torch.data.feeds import SyntheticTokenAdaptor

    class Repeat(SyntheticTokenAdaptor):
        def _record(self, i):
            return super()._record(i % batch)
    return Repeat(seq, vocab, seed)


def _profile_step(tr):
    """(host s, device busy s, device s by group, top kernels) of one
    Trainer step under torch.profiler; groups: K7, K8 (forward and
    backward), the cuBLAS products, the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.perf_counter()
        tr.run(1)
        wall = time.perf_counter() - t
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    groups = {"K7 (rmsnorm fwd+bwd)": 0.0, "K8 (flash fwd+bwd)": 0.0,
              "cuBLAS products": 0.0, "other": 0.0}
    for us, k, _ in rows:
        low = k.lower()
        g = ("K7 (rmsnorm fwd+bwd)" if "rmsnorm" in low else
             "K8 (flash fwd+bwd)" if "flash" in low else
             "cuBLAS products" if any(t in low for t in (
                 "gemm", "cublas", "cutlass", "xmma", "sm90_")) else "other")
        groups[g] += us / 1e6
    return wall, sum(r[0] for r in rows) / 1e6, groups, rows


def train_phase(seed):
    """Phase 4f: returns the launch counts of the main training run (the
    six Trainer steps at full width)."""
    import dataclasses
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import model_ops, ref, selfcheck
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import OptimizerConfig, tree_leaves
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.trainer import Trainer
    c = TRAIN
    B, S, steps = c["batch"], c["seq"], c["steps"]
    cfg = dataclasses.replace(get_config(c["arch"]),
                              num_layers=c["layers"])
    L = cfg.num_layers
    # remat "full": every layer's forward runs again inside the backward
    per_step = {"rmsnorm": 2 * (2 * L) + 1, "rmsnorm_bwd": 2 * L + 1,
                "flash_attention": 2 * L, "flash_attention_bwd": L}
    total = dict.fromkeys(selfcheck.KERNELS, 0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"train: {torch.cuda.memory_allocated()} B of device memory held "
          f"by earlier phases at the start; remat {cfg.remat_policy}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        tr = Trainer(cfg, global_batch=B, seq_len=S, ckpt_dir=tmp,
                     opt_cfg=OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                             decay_steps=steps), seed=seed)
        tr.feed.adaptor = _repeat_adaptor(S, cfg.vocab_size, seed, B)
        t = time.perf_counter()
        tr.init_state()
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in tree_leaves(tr.params))
        print(f"train: {cfg.name} d_model {cfg.d_model} heads "
              f"{cfg.num_heads} kv_heads {cfg.num_kv_heads} head_dim "
              f"{cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab "
              f"{cfg.vocab_size}, {L} of {get_config(c['arch']).num_layers}"
              f" layers: {n_params} float32 parameters made on the card in "
              f"{time.perf_counter() - t} s; global batch {B} x {S} "
              f"tokens, the same batch every step")
        secs = []
        with _OracleCalls() as oracle:
            for i in range(steps):
                selfcheck.reset_launch_counts()
                if i == steps - 1:
                    wall, busy, groups, top = _profile_step(tr)
                else:
                    t = time.perf_counter()
                    tr.run(1)
                    secs.append(time.perf_counter() - t)
                got = selfcheck.launch_counts()
                for k, n in per_step.items():
                    check(got[k] == n, f"train step {i + 1}: {k} launched "
                                       f"{got[k]} times, expected {n}")
                for k, n in got.items():
                    total[k] += n
        check(not any(oracle.calls.values()),
              f"train: plain versions ran on the card: {oracle.calls}")
        losses = [h["loss"] for h in tr.history]
        print(f"train: losses {losses}; grad_norm "
              f"{[h['grad_norm'] for h in tr.history]}; lr "
              f"{[h['lr'] for h in tr.history]}")
        check(all(math.isfinite(x) for x in losses),
              f"train: a loss is not finite: {losses}")
        check(losses[-1] < losses[0],
              f"train: the loss did not fall over {steps} steps: {losses}")
        print(f"train: launches a step {json.dumps(per_step)} (as expected, "
              f"every step); plain-version calls during the steps "
              f"{json.dumps(oracle.calls)}")
        med = sorted(secs[1:])[len(secs[1:]) // 2]
        print(f"train: {n_params} parameters; peak device memory "
              f"{torch.cuda.max_memory_allocated()} B; seconds a step "
              f"(host clock, Trainer.run(1) to its float() sync) {secs}, "
              f"median of steps 2-{steps - 1} {med}, "
              f"{B * S / med} tokens/s")
        if busy == 0:
            print(f"train profile: step {steps} {wall} s host clock; device "
                  f"busy not measured: the profiler recorded no kernel")
        else:
            print(f"train profile: step {steps} {wall} s host clock "
                  f"(profiler on), device busy {busy} s, idle share "
                  f"{1 - busy / wall}; device s by group "
                  f"{json.dumps(groups)}; top: "
                  + "; ".join(f"{k[:70]} {us / 1e3} ms x{n}"
                              for us, k, n in top[:8]))
        # -- one more step, its gradients held against the plain versions'
        batch = tr._next_batch()
        tr.opt_state = None                      # room for two gradients
        gc.collect()
        torch.cuda.empty_cache()
        loss_fn = M.make_loss_fn(cfg)
        selfcheck.reset_launch_counts()
        lk, _, gk = value_and_grad(loss_fn, tr.params, batch)
        check(selfcheck.launch_counts()["flash_attention_bwd"] == L,
              "train check: the kernel step did not run K8's backward")
        saved = (model_ops.rmsnorm, model_ops.flash_attention)
        model_ops.rmsnorm = lambda x, w, eps=1e-5: ref.rmsnorm_ref(x, w, eps)
        model_ops.flash_attention = (
            lambda q, k, v, causal=True, q_offset=0: ref.flash_attention_ref(
                q, k, v, causal=causal, q_offset=q_offset))
        try:
            selfcheck.reset_launch_counts()
            lp, _, gp = value_and_grad(loss_fn, tr.params, batch)
            plain_launches = selfcheck.launch_counts()
        finally:
            model_ops.rmsnorm, model_ops.flash_attention = saved
        check(not any(plain_launches[k] for k in TRAIN_PATH),
              f"train check: the plain step launched kernels "
              f"{plain_launches}")
        worst, worst_leaf = 0.0, None
        for i, (a, b) in enumerate(zip(tree_leaves(gk), tree_leaves(gp))):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            check(math.isfinite(err) and err <= GRAD_RTOL * scale,
                  f"train check: gradient leaf {i} {tuple(b.shape)} "
                  f"differs by {err} (largest {scale})")
            if scale and err / scale > worst:
                worst, worst_leaf = err / scale, (i, tuple(b.shape))
        print(f"train check: loss {float(lk)} (kernels) vs {float(lp)} "
              f"(plain versions on the card); every one of "
              f"{len(tree_leaves(gk))} gradient leaves within {GRAD_RTOL} "
              f"of its largest magnitude, worst {worst} (leaf "
              f"{worst_leaf})")
        del tr, gk, gp, batch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    crash_resume(seed)
    return total


def crash_resume(seed):
    """The reference's crash-recovery sequence (tests/test_feeds_
    checkpoint.py:167-192) on the card at reduced deepseek-67b widths:
    6 uninterrupted steps; a crash at step 4 with a checkpoint every 2
    steps; a restart that resumes at step 4.  The resumed losses must
    equal the uninterrupted run's bit for bit.  Run with PyTorch's
    deterministic algorithms (cuBLAS's workspace fixed by
    CUBLAS_WORKSPACE_CONFIG, set before the first product)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import OptimizerConfig, tree_leaves
    from repro_torch.training.trainer import InjectedFailure, Trainer
    c = TRAIN
    cfg = reduced(get_config(c["arch"]))
    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=20)
    kw = dict(global_batch=c["crash_batch"], seq_len=c["crash_seq"],
              opt_cfg=opt, seed=seed)
    d1 = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    d2 = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t_ref = Trainer(cfg, ckpt_dir=d1, **kw)
        t_ref.init_or_restore()
        t_ref.run(6)
        ref_losses = [h["loss"] for h in t_ref.history]
        t1 = Trainer(cfg, ckpt_dir=d2, **kw)
        t1.init_or_restore()
        crashed = False
        try:
            t1.run(6, checkpoint_every=2, fail_at_step=4)
        except InjectedFailure:
            crashed = True
        check(crashed, "crash_resume: the injected failure did not fire")
        t2 = Trainer(cfg, ckpt_dir=d2, **kw)
        t2.init_or_restore()
        check(t2.step == 4, f"crash_resume: resumed at step {t2.step}, "
                            f"expected 4")
        t2.run(2)
        rec = [h["loss"] for h in t2.history]
        check(rec == ref_losses[4:],
              f"crash_resume: resumed losses {rec} differ from the "
              f"uninterrupted run's {ref_losses[4:]}")
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(t2.params), tree_leaves(t_ref.params)))
        check(same, "crash_resume: resumed parameters differ")
        print(f"train crash_resume: {cfg.name} reduced (d_model "
              f"{cfg.d_model}, {cfg.num_layers} layers), global batch "
              f"{c['crash_batch']} x {c['crash_seq']}: crashed at step 4 "
              f"of 6 (checkpoints at 2 and 4), resumed at step 4; losses "
              f"of steps 5-6 {rec} equal the uninterrupted run's bit for "
              f"bit, and so do all parameters")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(d1, ignore_errors=True)
        shutil.rmtree(d2, ignore_errors=True)


def _profile_decode(serve, params, cfg, cache, first, pos, steps):
    """(host s, device busy s, kernels by device time) of ``steps``
    decode steps under torch.profiler; entries are (device us, name,
    calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.perf_counter()
        serve.decode(params, cfg, cache, first, pos, steps)
        wall = time.perf_counter() - t
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    return wall, sum(r[0] for r in rows) / 1e6, rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--messages", type=int, default=2_000_000)
    ap.add_argument("--users", type=int, default=200_000)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--flush-threshold", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    # -- 1. device ---------------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import obs
    from repro_torch.configs import tinysocial
    from repro_torch.core import adm, algebra
    from repro_torch.kernels import columnar_ops, device_pool, ops, selfcheck
    from repro_torch.columnar import plancache
    from repro_torch.storage import dataset, query
    repro_torch.set_device("cuda")
    # float32 products in full float32 (the PyTorch defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    ops.lib()
    built = (f"{ops.BUILD_SECONDS[0]} s nvcc (sm_90a, one process per "
             f"source)" if ops.BUILD_LOG else
             "reused the library an earlier process built from these "
             "sources")
    print(f"build: {built}; {time.perf_counter() - t0} s to a loaded "
          f"library")
    for log in ops.BUILD_LOG:
        for line in log.splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                print("  ptxas", line.strip())

    # -- 3. kernels against their plain versions ---------------------------
    dev = torch.device("cuda", 0)
    print("timer: " + ("torch.profiler device time (CUPTI)"
                       if selfcheck.profiler_works() else
                       "CUDA events around each call: torch.profiler "
                       "recorded no device time"))
    results = {}
    serve_shapes = {k: SERVE[k] for k in ("prompt", "gen", "tail_cap",
                                          "l1_comps")}
    for case in (selfcheck.main_path_cases(dev, seed=args.seed)
                 + selfcheck.rung_cases(dev, seed=args.seed)
                 + selfcheck.wide_pred_cases(dev, seed=args.seed)
                 + selfcheck.serve_cases(dev, args.seed, SERVE["requests"],
                                         **serve_shapes)
                 + selfcheck.train_cases(dev, args.seed, TRAIN["batch"],
                                         TRAIN["seq"])):
        r = selfcheck.run_case(case)
        print(f"kernel {r['kernel']} [{r['label']}]: max_abs_err "
              f"{r['max_abs_err']} ms {r['ms']} ({r['ms_timer']}; call "
              f"{r['call_ms']}) "
              f"plain_ms {r['plain_ms']} (call {r['plain_call_ms']}) "
              f"library_ms {r['library_ms']} (call {r['library_call_ms']})"
              f" bound_ms {r['bound_ms']} ({r['bound_by']})"
              + (f" bound_fp32_ms {r['bound_fp32_ms']} (float32 outside "
                 f"the tensor cores)" if "bound_fp32_ms" in r else "")
              + (f" cluster {r['cluster']}" if "cluster" in r else ""))
        check(r["ok"], f"{r['kernel']} [{r['label']}] disagrees with its "
                       f"plain version (max_abs_err {r['max_abs_err']})")
        results.setdefault(r["kernel"], []).append(r)

    # -- 4. main path ------------------------------------------------------
    port = {"adm": adm, "ts": tinysocial, "dsm": dataset}
    selfcheck.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ds, rec = build_tinysocial(args, port)
    qs = plans(algebra)
    # the per-operator path (the plan cache off): the index probes launch
    # K4, as before the fused chain was ported; phase 4a turns it on
    plancache.set_enabled(False)
    main_rows = {}
    for name, plan in qs.items():
        times = []
        for rep in range(1 + WARM_REPEATS):
            k2_h2d = obs.snapshot().get(K2_H2D, 0)
            t = time.perf_counter()
            rows, ex = query.run_query(plan, ds, vectorize=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            st = ex.stats
            if rep == 0:
                cold = st
                continue
            check(st.kernel_retraces == 0, f"{name}: warm retraces")
            check(st.rows_fallback == 0, f"{name}: warm row fallback "
                                         f"{st.fallback_reasons}")
            # resident operands never re-ship; the gathered survivors of
            # a residual-checked aggregate are K2's only uploads
            shipped = st.h2d_bytes - (obs.snapshot().get(K2_H2D, 0) - k2_h2d
                                      if name in GATHERED else 0)
            check(shipped == 0, f"{name}: warm h2d {st.h2d_bytes}")
        check(cold.rows_fallback == 0, f"{name}: cold row fallback")
        numpy_oracle(name, rows, rec)
        main_rows[name] = rows
        if name == "index_chain_aggregate":
            # its exact-range twin, phases 4a and 4b's new query, on the
            # per-operator path: the rows they are checked against
            twin = rung_plans(algebra)[0]["index_chain_aggregate_exact"]
            main_rows["index_chain_aggregate_exact"], _ = query.run_query(
                twin, ds, vectorize=True)
        t = time.perf_counter()
        rrows, _ = query.run_query(plan, ds, vectorize=False)
        t_row = time.perf_counter() - t
        check(canon(rrows) == canon(rows), f"{name}: row engine")
        warm = sorted(times[1:])
        busy = selfcheck.device_ms(
            lambda: query.run_query(plan, ds, vectorize=True))
        med = warm[len(warm) // 2]
        if busy is None or (busy == 0 and st.kernel_dispatches):
            idle = "busy not measured: the profiler recorded no kernel"
        else:
            idle = f"busy_s {busy / 1e3}, idle share {1 - busy / 1e3 / med}"
        print(f"query {name}: rows {len(rows)} cold_s {times[0]} "
              f"warm_s_median {med} (host clock to synchronize; "
              f"{WARM_REPEATS} warm runs) warm device {idle} "
              f"(profiler) cold_h2d {cold.h2d_bytes} warm_h2d "
              f"{st.h2d_bytes} warm_d2h {st.d2h_bytes} warm_dispatches "
              f"{st.kernel_dispatches} rows_vectorized {st.rows_vectorized}"
              f" checked against the row engine ({t_row} s) and numpy")
    counts = selfcheck.launch_counts()
    splits = {"columnar": selfcheck.launch_splits()}
    print(f"main: launches {json.dumps(counts)}")
    seen = sorted(k for k in columnar_ops._SEEN if k[0] in COLUMNAR_PATH)
    print(f"main: kernel shapes seen {seen}")
    for k in COLUMNAR_PATH:
        check(counts[k] > 0, f"kernel {k} never launched on the main path")
    plancache.set_enabled(True)

    # -- 4a. rung 3: the fused chain ---------------------------------------
    selfcheck.reset_launch_counts()
    t0 = time.perf_counter()
    rung3_phase(ds, rec, main_rows)
    rung3_counts = selfcheck.launch_counts()
    a6 = selfcheck.KERNELS["fused_index_chain"]["wrapper"]
    a6_clears = {"rung3": a6.clears}
    print(f"rung3: launches {json.dumps(rung3_counts)}; A6 dispatches "
          f"that zeroed the flags first {a6.clears} (the others: the "
          f"scatter and pass 2, no memset); phase took "
          f"{time.perf_counter() - t0} s (host clock)")
    for k in RUNG3_PATH:
        check(rung3_counts[k] > 0, f"kernel {k} never launched on the "
                                   f"rung-3 path")

    # -- 4b. rung 4: the partition mesh ------------------------------------
    selfcheck.reset_launch_counts()
    t0 = time.perf_counter()
    rung4_phase(ds, rec, main_rows)
    rung4_counts = selfcheck.launch_counts()
    a6_clears["rung4"] = a6.clears
    k2s = selfcheck.KERNELS["filter_aggregate_stacked"]["wrapper"]
    k2s_first = k2s.launches_first
    print(f"rung4: launches {json.dumps(rung4_counts)}; A6 dispatches "
          f"that zeroed the flags first {a6.clears}; stacked K2 launches "
          f"by its first design {k2s_first} (the others: "
          f"rows_agg_kernel); phase took {time.perf_counter() - t0} s "
          f"(host clock)")
    for k in RUNG4_PATH:
        check(rung4_counts[k] > 0, f"kernel {k} never launched on the "
                                   f"rung-4 path")
    check(k2s_first == 0, f"stacked K2 took its first design "
                          f"{k2s_first} times on the rung-4 path")

    # -- 4c. fuzzy path ----------------------------------------------------
    selfcheck.reset_launch_counts()
    t0 = time.perf_counter()
    k6_split = fuzzy_phase(ds, rec)
    fuzzy_counts = selfcheck.launch_counts()
    splits["fuzzy"] = selfcheck.launch_splits()
    print(f"fuzzy: launches {json.dumps(fuzzy_counts)}; phase took "
          f"{time.perf_counter() - t0} s (host clock)")
    for k in FUZZY_PATH:
        check(fuzzy_counts[k] > 0,
              f"kernel {k} never launched on the fuzzy path")
    # the ngram probes (K4 at T > 1) all took the sorted row-tile kernel
    k4 = splits["fuzzy"]["t_occurrence_mask"]
    print(f"fuzzy: K4 launches by threshold and route {json.dumps(k4)}")
    check(k4["T>1 sorted"] > 0 and k4["T>1 scatter"] == 0,
          f"fuzzy K4 launches at T > 1 not all by the sorted kernel: {k4}")
    # -- 4d. feeds phase ---------------------------------------------------
    selfcheck.reset_launch_counts()
    t0 = time.perf_counter()
    feeds_phase(args.seed, card)
    feeds_counts = selfcheck.launch_counts()
    a6_clears["feeds"] = a6.clears
    print(f"feeds: launches {json.dumps(feeds_counts)}; A6 dispatches that "
          f"zeroed the flags first {a6.clears}; phase took "
          f"{time.perf_counter() - t0} s (host clock)")
    for k in FEEDS_PATH:
        check(feeds_counts[k] > 0, f"kernel {k} never launched in the "
                                   f"feeds phase")

    # -- 4e. serve path ----------------------------------------------------
    t0 = time.perf_counter()
    serve_counts = serve_phase(args.seed)
    print(f"serve: phase took {time.perf_counter() - t0} s (host clock)")
    for k in SERVE_PATH:
        check(serve_counts[k] > 0, f"kernel {k} never launched on the "
                                   f"serve path")
    snap = obs.snapshot()
    print(f"main: buffer_pool.resident_bytes "
          f"{snap.get('buffer_pool.resident_bytes')} entries "
          f"{device_pool.pool.entry_count()} "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()}")

    # -- 4f. train path ----------------------------------------------------
    # the query phases' resident columns are not needed any more: the
    # train step wants the card's memory
    device_pool.clear()
    del ds, rec
    t0 = time.perf_counter()
    train_counts = train_phase(args.seed)
    print(f"train: phase took {time.perf_counter() - t0} s (host clock)")
    for k in TRAIN_PATH:
        check(train_counts[k] > 0, f"kernel {k} never launched on the "
                                   f"train path")

    # -- 5. kernels line, card line, ok line -------------------------------
    line = []
    for name, meta in selfcheck.KERNELS.items():
        r = results[name][0]
        entry = {"name": name, "route": "cuda", "source": meta["source"],
                 "replaces": meta["replaces"],
                 "launches": (counts[name] + rung3_counts[name]
                              + rung4_counts[name] + fuzzy_counts[name]
                              + feeds_counts[name] + serve_counts[name]
                              + train_counts[name]),
                 "launches_columnar": counts[name],
                 "launches_rung3": rung3_counts[name],
                 "launches_rung4": rung4_counts[name],
                 "launches_fuzzy": fuzzy_counts[name],
                 "launches_feeds": feeds_counts[name],
                 "launches_serve": serve_counts[name],
                 "launches_train": train_counts[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "ms_timer": r["ms_timer"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
                 "library_call_ms": r["library_call_ms"],
                 "shape": r["label"]}
        if "cluster" in r:        # K7, K9: the cluster size each case used
            entry["cluster"] = {o["label"]: o["cluster"]
                                for o in results[name]}
        if "bound_fp32_ms" in r:  # K8: the float32 non-tensor-core bound
            entry["bound_fp32_ms"] = r["bound_fp32_ms"]
        if name == "t_occurrence_mask":
            entry["launches_split"] = {
                f"{phase} {t}": n for phase, sp in splits.items()
                for t, n in sp[name].items()}
        if name == "set_intersect_counts":
            entry["launches_split"] = k6_split
        if name == "fused_index_chain":   # memsets of the pooled flags
            entry["flag_clears"] = a6_clears
        if name == "filter_aggregate_stacked":
            entry["launches_first_design_rung4"] = k2s_first
        if len(results[name]) > 1:
            entry["other_shapes"] = [
                {k: o[k] for k in ("label", "max_abs_err", "ms", "call_ms",
                                   "plain_ms", "library_ms", "bound_ms")}
                for o in results[name][1:]]
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(f"chip_smoke: whole run {time.perf_counter() - t_start} s "
          f"(host clock, kernel build included)")
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
