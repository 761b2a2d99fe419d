#!/usr/bin/env python3
"""The hash exchange of rung 4 (``runtime/spmd.exchange_batches``) at
grouped_topk's shape, split into its host and device parts, for one or
two source trees (two run A B B A, each in a process of its own).

The data is what ``chip_smoke.py``'s grouped_topk hands the exchange at
``mesh=4``: each of the 4 messages partitions' partial groups by
author-id.  ``configs/tinysocial.gen_messages`` draws author-ids uniformly
over the users; here each partition's 500,000 messages (2,000,000 over 4)
draw theirs with numpy from a seed over 200,000 users, and the tree's own
``operators.group_aggregate(..., "partial")`` groups them: about 183,600
groups a partition, columns ``author-id`` and ``cnt`` (int64, every row
valid).

Per tree it prints one JSON line: ``host_ms``, the host clock of one
``exchange_batches`` call to a synchronize (median of ``--iters``);
``split_ms``, the same call's parts timed one by one on the host clock
(each ending in a synchronize where it queues device work), as that tree
builds them; ``device_us``, the device µs a call of each kernel and copy
by name with the L2 write-flushed before each call
(``time_model_kernels.split_us``), and ``rows_equal``: the exchange's
batches equal the host bucketing's (``columnar/lower.py``), row for row.

The parent's parts (the send planes): hash and argsort, plane fill, pack,
h2d, kernel, d2h, concatenation.  The partitions built on the card:
staging (the sources' columns back to back in pinned memory), h2d,
kernels, d2h, views.

Usage:  python scripts/probes/exchange_split.py [--src DIR [--src DIR]]
            [--iters 20]        (from the repository root)
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
P, USERS, MESSAGES, KEYS = 4, 200_000, 2_000_000, ("author-id",)


def partials(O, CB, Column, seed: int = 0) -> list:
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    per = MESSAGES // P
    for _ in range(P):
        ids = rng.integers(0, USERS, per).astype(np.int64)
        b = CB({"author-id": Column("i64", ids, np.ones(per, bool), None)},
               per)
        out.append(O.group_aggregate(b, KEYS, {"cnt": ("count", "*")},
                                     "partial"))
    return out


def host_buckets(O, CB, cparts) -> list:
    """``columnar/lower.py``'s host bucketing of the same batches."""
    buckets = [[] for _ in range(P)]
    for i, b in enumerate(cparts):
        ids = O.partition_ids(b, KEYS, P)
        for j in range(P):
            sel = ids == j
            if sel.any():
                buckets[j].append(b.filter(sel))
    return [CB.concat(bs) for bs in buckets]


def _timed(parts: dict, name: str, fn):
    import torch
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    parts.setdefault(name, []).append(1e3 * (time.perf_counter() - t))
    return out


def parent_split(SO, O, cparts, dev, parts: dict) -> None:
    """The parent's exchange_batches, step by step (its own code)."""
    import numpy as np
    import torch
    from repro_torch.columnar.batch import Column, pow2_len

    def order():
        counts = np.zeros((P, P), dtype=np.int64)
        orders = []
        for i, b in enumerate(cparts):
            pid = O.partition_ids(b, KEYS, P)
            orders.append(np.argsort(pid, kind="stable"))
            counts[i] = np.bincount(pid, minlength=P)
        return counts, orders
    counts, orders = _timed(parts, "hash_argsort", order)
    cap = pow2_len(int(counts.max()))
    names = sorted(cparts[0].columns)

    def fill():
        send = []
        for nm in names:
            dt0 = cparts[0].columns[nm].data.dtype
            data_s = np.zeros((P, P, cap), dtype=dt0)
            valid_s = np.zeros((P, P, cap), dtype=bool)
            for i, b in enumerate(cparts):
                col = b.columns[nm]
                d_srt = col.data[orders[i]]
                v_srt = col.valid[orders[i]]
                offs = np.concatenate([[0], np.cumsum(counts[i])])
                for j in range(P):
                    a, z = int(offs[j]), int(offs[j + 1])
                    data_s[i, j, :z - a] = d_srt[a:z]
                    valid_s[i, j, :z - a] = v_srt[a:z]
            send.extend((data_s, valid_s))
        return send
    send = _timed(parts, "plane_fill", fill)
    buf, meta = _timed(parts, "pack", lambda: SO.pack_planes(send))
    dbuf = _timed(parts, "h2d", lambda: torch.from_numpy(buf).to(dev))
    recv_d = _timed(parts, "kernel", lambda: SO.exchange_cuda(dbuf, meta, P))
    host = _timed(parts, "d2h", lambda: recv_d.cpu().numpy())

    def concat():
        recv = [host[o:o + a.nbytes].view(a.dtype).reshape(a.shape)
                for a, (o, _b, _g) in zip(send, meta.tolist())]
        out = []
        for j in range(P):
            cols = {}
            for c, nm in enumerate(names):
                cols[nm] = Column("i64", np.concatenate(
                    [recv[2 * c][j, i, :counts[i, j]] for i in range(P)]),
                    np.concatenate([recv[2 * c + 1][j, i, :counts[i, j]]
                                    for i in range(P)]), None)
            out.append(cols)
        return out
    _timed(parts, "concatenation", concat)


def card_split(SO, SP, cparts, dev, parts: dict) -> None:
    """The partitions built on the card, step by step (its own code)."""
    with SP.use_partition_mesh(P):
        cols, rows, key, names, kinds = _timed(
            parts, "plan", lambda: SP._exchange_plan(cparts, KEYS, P))
    stage, lay = _timed(parts, "staging",
                        lambda: SO.stage_exchange(cols, rows, key, P))
    send = _timed(parts, "h2d",
                  lambda: stage.to(dev, non_blocking=True))
    recv = _timed(parts, "kernels", lambda: SO.exchange_cuda(send, lay))
    host = _timed(parts, "d2h", lambda: SO.download(recv))
    _timed(parts, "views",
           lambda: SP._exchange_views(host, lay, names, kinds))


def one(src: str, run: int, iters: int) -> int:
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT / "scripts"))
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.columnar import operators as O
    from repro_torch.columnar.batch import Column, ColumnBatch as CB
    from repro_torch.kernels import spmd_ops as SO
    from repro_torch.runtime import spmd as SP
    from time_model_kernels import split_us
    if not torch.cuda.is_available():
        print("exchange_split: no CUDA device", file=sys.stderr)
        return 2
    repro_torch.set_device("cuda")
    dev = torch.device("cuda", 0)
    cparts = partials(O, CB, Column)
    want = host_buckets(O, CB, cparts)

    def call():
        with SP.use_partition_mesh(P):
            return SP.exchange_batches(cparts, KEYS, P)
    out, moved = call()
    equal = all(
        len(out[j]) == len(want[j]) and all(
            np.array_equal(out[j].columns[nm].data[:len(want[j])],
                           want[j].columns[nm].data)
            and np.array_equal(out[j].columns[nm].valid[:len(want[j])],
                               want[j].columns[nm].valid)
            for nm in want[j].columns)
        for j in range(P))
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    host = []
    for _ in range(iters):
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t))
    parts: dict = {}
    split = parent_split if hasattr(SO, "pack_planes") else card_split
    for _ in range(iters):
        split(SO, O if split is parent_split else SP, cparts, dev, parts)
    with SP.use_partition_mesh(P):
        dev_us = split_us(lambda: SP.exchange_batches(cparts, KEYS, P),
                          iters)
    print(json.dumps({
        "tree": src, "run": run, "rows": [len(b) for b in cparts],
        "moved": moved, "rows_equal": equal,
        "host_ms": float(np.median(host)),
        "split_ms": {k: float(np.median(v)) for k, v in parts.items()},
        "device_us": dev_us}), flush=True)
    return 0 if equal else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one(args.one, args.run, args.iters)
    srcs = [str(Path(s).resolve()) for s in (args.src or [ROOT / "src"])]
    order = srcs if len(srcs) == 1 else [srcs[0], srcs[1], srcs[1], srcs[0]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    for i, src in enumerate(order):
        rc = subprocess.run([sys.executable, __file__, "--one", src,
                             "--run", str(i), "--iters",
                             str(args.iters)]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
