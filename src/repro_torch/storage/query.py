"""Partitioned query executor — runs the rewriter's PhysicalOp plans over
PartitionedDatasets (the Hyracks role, host-side record engine).

Data between operators is a list of per-partition row lists; Connectors
redistribute it exactly as the paper's connector library does:

  OneToOne                 keep partition alignment
  MToNHashPartition(keys)  re-bucket rows by hash of the key columns
  MToNHashPartitionMerge   re-bucket + merge keeping sort order
  MToNReplicate            every partition receives the concatenation
  ReplicateToOne           fan-in to a single partition (global ops)

The executor also collects per-query counters (rows moved per connector,
operator cardinalities) used by the benchmarks to show e.g. the Figure-6
local/global aggregation split reducing "network" traffic.

``Executor(..., vectorize=True)`` additionally offers every operator to
the columnar engine first (columnar/lower.try_lower): supported subplans
— scans, sargable selects, index access paths (secondary/rtree/keyword
CSR-postings probe -> candidate bitmap -> gather + post-validate),
aggregates,
groups, sorts/top-k, equijoins — execute on ColumnBatches with
hand-written CUDA kernels (kernels/columnar_ops) and convert back to row dicts
only at the boundary; everything else (opaque predicates without
ranges, bare joins at the root) falls back to the row engine below, and
``ExecStats`` records rows_vectorized / rows_index_vectorized vs
rows_fallback.
"""

from __future__ import annotations

import contextlib
import heapq
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import obs as _obs
from ..core.algebra import Connector, PhysicalOp
from ..core.rewriter import Catalog, RewriteConfig, optimize
from .dataset import DatasetSnapshot, PartitionedDataset, hash_partition

__all__ = ["Executor", "run_query", "explain_analyze"]

Rows = List[Dict[str, Any]]
Parts = List[Rows]


@dataclass
class ExecStats:
    rows_moved: Dict[str, int] = field(default_factory=dict)
    op_rows: Dict[str, int] = field(default_factory=dict)
    rows_vectorized: int = 0    # produced by columnar-lowered operators
    rows_fallback: int = 0      # produced by the row engine while
    #                             vectorize=True (unsupported subplans)
    rows_index_vectorized: int = 0   # subset of rows_vectorized produced
    #                             by vectorized index access paths (index
    #                             search -> bitmap intersect -> gather)
    rows_fuzzy_vectorized: int = 0   # subset of rows_index_vectorized
    #                             produced by the fuzzy ngram chains
    #                             (T-occurrence bitmap -> batched verify)
    kernel_retraces: int = 0    # first sightings of (kernel, shape, dtypes)
    #                             this query triggered: repeated queries
    #                             over pow2-padded batches must show 0
    fallback_reasons: Dict[str, int] = field(default_factory=dict)
    #                             "OP_KIND: reason" -> occurrences, one
    #                             entry per subplan the columnar engine
    #                             declined (empty when nothing fell back)
    kernel_dispatches: int = 0  # device-bound kernel calls this query made
    h2d_bytes: int = 0          # operand bytes shipped host -> device
    d2h_bytes: int = 0          # result bytes fetched device -> host
    plan_cache_hits: int = 0    # fused chain dispatches reusing a
    #                             compiled plan shape (columnar/plancache)
    plan_cache_misses: int = 0  # fused chain plan shapes first seen (and
    #                             trace-compiled) during this query
    spmd_dispatches: int = 0    # stacked all-partition dispatches
    #                             this query made (runtime/spmd; 0 off-mesh)
    spmd_partitions: int = 0    # partitions those dispatches covered (the
    #                             python loop would have paid one dispatch
    #                             + one device_get per partition instead)

    def moved(self, conn: str, n: int) -> None:
        self.rows_moved[conn] = self.rows_moved.get(conn, 0) + n

    def produced(self, op: str, parts: Parts) -> None:
        self.op_rows[op] = self.op_rows.get(op, 0) + sum(map(len, parts))

    def vectorized(self, op: str, n: int) -> None:
        self.op_rows[op] = self.op_rows.get(op, 0) + n
        self.rows_vectorized += n

    def index_vectorized(self, op: str, n: int) -> None:
        self.op_rows[op] = self.op_rows.get(op, 0) + n
        self.rows_vectorized += n
        self.rows_index_vectorized += n

    def fuzzy_vectorized(self, op: str, n: int) -> None:
        self.index_vectorized(op, n)
        self.rows_fuzzy_vectorized += n

    def fell_back(self, op: str, reason: str) -> None:
        key = f"{op}: {reason}"
        self.fallback_reasons[key] = self.fallback_reasons.get(key, 0) + 1


class Executor:
    def __init__(self, datasets: Dict[str, PartitionedDataset],
                 vectorize: bool = False):
        self.datasets = datasets
        self.num_partitions = max(ds.num_partitions
                                  for ds in datasets.values())
        self.stats = ExecStats()
        self.vectorize = vectorize
        # explain_analyze: id(plan node) -> per-operator measurements
        # (None = plain execution, zero instrumentation overhead)
        self.analysis: Optional[Dict[int, Dict[str, Any]]] = None
        self._fallback_reasons: Optional[Dict[int, str]] = None

    # -- connectors ----------------------------------------------------------
    def _apply_connector(self, conn: Connector, parts: Parts) -> Parts:
        P = self.num_partitions
        if conn.name == "OneToOne":
            return parts
        if conn.name in ("MToNHashPartition", "MToNHashPartitionMerge"):
            out: Parts = [[] for _ in range(P)]
            moved = 0
            for i, rows in enumerate(parts):
                for r in rows:
                    j = hash_partition(tuple(r[k] for k in conn.keys)
                                       if len(conn.keys) > 1
                                       else r[conn.keys[0]], P)
                    if j != i:
                        moved += 1
                    out[j].append(r)
            if conn.name == "MToNHashPartitionMerge" and conn.sort_keys:
                for rows in out:
                    rows.sort(key=lambda r: tuple(r[k]
                                                  for k in conn.sort_keys))
            self.stats.moved(conn.name, moved)
            return out
        if conn.name == "MToNReplicate":
            allrows = [r for rows in parts for r in rows]
            self.stats.moved(conn.name, len(allrows) * (P - 1))
            return [list(allrows) for _ in range(P)]
        if conn.name == "ReplicateToOne":
            allrows = [r for rows in parts for r in rows]
            self.stats.moved(conn.name,
                             sum(len(rows) for rows in parts[1:]))
            out = [[] for _ in range(P)]
            out[0] = allrows
            return out
        raise ValueError(conn.name)

    def _input(self, op: PhysicalOp, i: int) -> Parts:
        child = self.execute_op(op.children[i])
        return self._apply_connector(op.connectors[i], child)

    # -- operators -------------------------------------------------------------
    def execute_op(self, op: PhysicalOp) -> Parts:
        # fast path: no explain, no tracing — one attribute check plus one
        # module-flag check on top of the actual operator work
        if self.analysis is None and not _obs.enabled():
            return self._run_op(op)[0]
        kt0 = _obs.kernel_totals()
        moved0 = sum(self.stats.rows_moved.values())
        t0 = time.perf_counter()
        with _obs.span("exec." + op.kind) as sp:
            parts, mode = self._run_op(op)
        wall = time.perf_counter() - t0
        kt1 = _obs.kernel_totals()
        rows_out = sum(map(len, parts))
        sp.set("mode", mode)
        sp.set("rows_out", rows_out)
        if self.analysis is not None:
            # inclusive values (children execute inside _run_op);
            # explain_analyze derives per-operator exclusive ones
            entry = {
                "op": op.kind, "mode": mode, "wall_s": wall,
                "rows_out": rows_out,
                "rows_moved": sum(self.stats.rows_moved.values()) - moved0,
                "kernel_dispatches": kt1[0] - kt0[0],
                "h2d_bytes": kt1[1] - kt0[1],
                "d2h_bytes": kt1[2] - kt0[2],
            }
            reason = (self._fallback_reasons or {}).pop(id(op), None)
            if reason is not None:
                entry["fallback_reason"] = reason
            self.analysis[id(op)] = entry
        return parts

    def _run_op(self, op: PhysicalOp) -> Tuple[Parts, str]:
        """Execute one operator (children recurse through execute_op).
        Returns (parts, mode): "columnar" when the subtree lowered,
        "fallback" when the row engine ran under vectorize=True, "row"
        otherwise."""
        k = op.kind
        P = self.num_partitions

        if self.vectorize:
            from ..columnar.lower import try_lower
            lowered = try_lower(op, self)
            if lowered is not None:
                return lowered(), "columnar"

        if k == "DATASET_SCAN":
            ds = self.datasets[op.attrs["dataset"]]
            parts = [ds.scan_partition(i) for i in range(ds.num_partitions)]
            parts += [[] for _ in range(P - ds.num_partitions)]

        elif k == "SECONDARY_INDEX_SEARCH":
            ds = self.datasets[op.attrs["dataset"]]
            fld, lo, hi = op.attrs["field"], op.attrs["lo"], op.attrs["hi"]
            parts = []
            for i in range(ds.num_partitions):
                pks = ds.secondary_search_partition(i, fld, lo, hi)
                parts.append([{"__pk": pk} for pk in pks])
            parts += [[] for _ in range(P - ds.num_partitions)]

        elif k == "SPATIAL_INDEX_SEARCH":
            ds = self.datasets[op.attrs["dataset"]]
            center, radius = op.attrs["args"]
            parts = []
            for i in range(ds.num_partitions):
                pks = ds.spatial_search_partition(i, op.attrs["field"],
                                                  center, radius)
                parts.append([{"__pk": pk} for pk in pks])
            parts += [[] for _ in range(P - ds.num_partitions)]

        elif k == "KEYWORD_INDEX_SEARCH":
            ds = self.datasets[op.attrs["dataset"]]
            token, fuzzy_ed = op.attrs["args"]
            parts = []
            for i in range(ds.num_partitions):
                pks = ds.keyword_search_partition(i, op.attrs["field"],
                                                  token, fuzzy_ed)
                parts.append([{"__pk": pk} for pk in sorted(set(pks))])
            parts += [[] for _ in range(P - ds.num_partitions)]

        elif k == "NGRAM_INDEX_SEARCH":
            ds = self.datasets[op.attrs["dataset"]]
            parts = []
            for i in range(ds.num_partitions):
                pairs = ds.ngram_search_partition(i, op.attrs["field"],
                                                  op.attrs["spec"])
                parts.append([{"__pk": pk, "__hits": h} for pk, h in pairs])
            parts += [[] for _ in range(P - ds.num_partitions)]

        elif k == "T_OCCURRENCE":
            # keep candidates with >= T gram hits (T <= 0: the ngram
            # search already emitted exactly the indexable rows)
            from ..fuzzy.ngram import query_grams
            _, thr = query_grams(op.attrs["spec"], op.attrs["gram_length"])
            parts = [[{"__pk": r["__pk"]} for r in rows
                      if r["__hits"] >= thr]
                     for rows in self._input(op, 0)]

        elif k == "SORT_PK":
            parts = [sorted(rows, key=lambda r: r["__pk"])
                     for rows in self._input(op, 0)]

        elif k == "PRIMARY_INDEX_LOOKUP":
            ds = self.datasets[op.attrs["dataset"]]
            inp = self._input(op, 0)
            parts = [ds.primary_lookup_partition(i, [r["__pk"] for r in rows])
                     if i < ds.num_partitions else []
                     for i, rows in enumerate(inp)]

        elif k == "POST_VALIDATE_SELECT":
            # §4.4: re-check the search criteria against the primary record
            pred = op.attrs["pred"]
            parts = [[r for r in rows if pred(r)]
                     for rows in self._input(op, 0)]

        elif k == "STREAM_SELECT":
            pred = op.attrs["pred"]
            parts = [[r for r in rows if pred(r)]
                     for rows in self._input(op, 0)]

        elif k == "STREAM_PROJECT":
            cols = op.attrs["cols"]
            parts = [[{c: r[c] for c in cols if c in r} for r in rows]
                     for rows in self._input(op, 0)]

        elif k == "HYBRID_HASH_JOIN":
            lk, rk = op.attrs["lkeys"], op.attrs["rkeys"]
            left, right = self._input(op, 0), self._input(op, 1)
            parts = []
            for lrows, rrows in zip(left, right):
                # build on the right, probe with the left
                table: Dict[Any, List[Dict[str, Any]]] = {}
                for r in rrows:
                    table.setdefault(tuple(r[k2] for k2 in rk), []).append(r)
                out = []
                for l in lrows:
                    for r in table.get(tuple(l[k2] for k2 in lk), ()):
                        out.append({**r, **l})
                parts.append(out)

        elif k == "INDEX_NL_JOIN":
            # paper Query 14: probe the right side's primary index per row
            lk = op.attrs["lkeys"]
            rds = self.datasets[op.attrs["right_dataset"]]
            left = self._input(op, 0)
            parts = []
            for lrows in left:
                out = []
                for l in lrows:
                    r = rds.lookup(l[lk[0]])
                    if r is not None:
                        out.append({**r, **l})
                parts.append(out)

        elif k == "LOCAL_AGG":
            parts = [[_agg_row(rows, op.attrs["aggs"], partial=True)]
                     for rows in self._input(op, 0)]

        elif k == "GLOBAL_AGG":
            inp = self._input(op, 0)
            allrows = [r for rows in inp for r in rows]
            parts = [[] for _ in range(P)]
            parts[0] = [_agg_merge(allrows, op.attrs["aggs"])]

        elif k in ("LOCAL_PREAGG", "HASH_GROUP", "GLOBAL_GROUP"):
            inp = self._input(op, 0)
            keys, aggs = op.attrs["keys"], op.attrs["aggs"]
            partial = (k == "LOCAL_PREAGG")
            merge = (k == "GLOBAL_GROUP")
            parts = []
            for rows in inp:
                groups: Dict[Tuple, Rows] = {}
                for r in rows:
                    groups.setdefault(tuple(r[kk] for kk in keys),
                                      []).append(r)
                out = []
                for gk, grows in groups.items():
                    row = (_agg_merge(grows, aggs) if merge
                           else _agg_row(grows, aggs, partial=partial))
                    row.update(dict(zip(keys, gk)))
                    out.append(row)
                parts.append(out)

        elif k == "LOCAL_SORT":
            keyf = _sort_key(op.attrs["keys"])
            parts = [sorted(rows, key=keyf, reverse=op.attrs.get("desc",
                                                                 False))
                     for rows in self._input(op, 0)]

        elif k == "SORT_MERGE_GATHER":
            inp = self._input(op, 0)
            keyf = _sort_key(op.attrs["keys"])
            allrows = [r for rows in inp for r in rows]
            parts = [[] for _ in range(P)]
            parts[0] = sorted(allrows, key=keyf,
                              reverse=op.attrs.get("desc", False))

        elif k == "LOCAL_TOPK":
            keyf = _sort_key(op.attrs["keys"])
            n = op.attrs["n"]
            parts = [sorted(rows, key=keyf,
                            reverse=op.attrs.get("desc", False))[:n]
                     for rows in self._input(op, 0)]

        elif k == "TOPK_MERGE":
            inp = self._input(op, 0)
            keyf = _sort_key(op.attrs["keys"])
            allrows = [r for rows in inp for r in rows]
            parts = [[] for _ in range(P)]
            parts[0] = sorted(allrows, key=keyf,
                              reverse=op.attrs.get("desc", False))[
                                  :op.attrs["n"]]

        elif k == "STREAM_LIMIT":
            inp = self._input(op, 0)
            parts = [rows[:op.attrs["n"]] for rows in inp]

        else:
            raise ValueError(f"unknown physical operator {k}")

        self.stats.produced(k, parts)
        if self.vectorize:
            self.stats.rows_fallback += sum(map(len, parts))
            return parts, "fallback"
        return parts, "row"


def _sort_key(keys: Sequence[str]) -> Callable:
    return lambda r: tuple(r[k] for k in keys)


def _agg_row(rows: Rows, aggs: Dict[str, Tuple[str, str]],
             partial: bool) -> Dict[str, Any]:
    """Local (partial) aggregation: avg is carried as (sum, count)."""
    out: Dict[str, Any] = {}
    for name, (fn, col) in aggs.items():
        vals = [r[col] for r in rows if col in r and r[col] is not None] \
            if col != "*" else rows
        if fn == "count":
            out[name] = len(vals)
        elif fn == "sum":
            out[name] = sum(vals) if vals else 0
        elif fn == "min":
            out[name] = min(vals) if vals else None
        elif fn == "max":
            out[name] = max(vals) if vals else None
        elif fn == "avg":
            if partial:
                out[name + "__sum"] = sum(vals) if vals else 0
                out[name + "__cnt"] = len(vals)
            else:
                out[name] = (sum(vals) / len(vals)) if vals else None
        else:
            raise ValueError(fn)
    return out


def _agg_merge(rows: Rows, aggs: Dict[str, Tuple[str, str]]
               ) -> Dict[str, Any]:
    """Global aggregation: merge partial rows if present, else aggregate raw
    rows directly (no-split configuration)."""
    out: Dict[str, Any] = {}
    for name, (fn, col) in aggs.items():
        if rows and (name in rows[0] or name + "__sum" in rows[0]):
            # merging partials
            if fn == "count" or fn == "sum":
                out[name] = sum(r[name] for r in rows)
            elif fn == "min":
                vals = [r[name] for r in rows if r[name] is not None]
                out[name] = min(vals) if vals else None
            elif fn == "max":
                vals = [r[name] for r in rows if r[name] is not None]
                out[name] = max(vals) if vals else None
            elif fn == "avg":
                s = sum(r[name + "__sum"] for r in rows)
                c = sum(r[name + "__cnt"] for r in rows)
                out[name] = s / c if c else None
        else:
            out.update(_agg_row(rows, {name: (fn, col)}, partial=False))
    return out


def _default_catalog(datasets: Dict[str, PartitionedDataset]) -> Catalog:
    """Catalog inferred from the datasets' own index declarations."""
    catalog = Catalog(
        primary_keys={n: ds.primary_key
                      for n, ds in datasets.items()},
        indexes=[],
        num_partitions=max(ds.num_partitions
                           for ds in datasets.values()))
    from ..core.rewriter import IndexInfo
    for n, ds in datasets.items():
        for fld in ds.index_fields:
            catalog.indexes.append(IndexInfo(
                f"{n}_{fld}_idx", n, fld,
                kind=getattr(ds, "index_kinds", {}).get(fld, "btree"),
                gram_length=getattr(ds, "_ngram_specs",
                                    {}).get(fld, 3)))
    return catalog


def _finish_stats(ex: "Executor", traces0: int,
                  kt0: Tuple[int, int, int],
                  pc0: Tuple[int, int],
                  sp0: Tuple[int, int] = (0, 0)) -> None:
    from ..columnar import plancache as _pc
    from ..kernels import columnar_ops as K
    from ..runtime import spmd as _sp
    kt1 = _obs.kernel_totals()
    pc1 = _pc.totals()
    sp1 = _sp.dispatch_totals()
    ex.stats.kernel_retraces = K.trace_count() - traces0
    ex.stats.kernel_dispatches = kt1[0] - kt0[0]
    ex.stats.h2d_bytes = kt1[1] - kt0[1]
    ex.stats.d2h_bytes = kt1[2] - kt0[2]
    ex.stats.plan_cache_hits = pc1[0] - pc0[0]
    ex.stats.plan_cache_misses = pc1[1] - pc0[1]
    ex.stats.spmd_dispatches = sp1[0] - sp0[0]
    ex.stats.spmd_partitions = sp1[1] - sp0[1]


def _mesh_context(mesh: Optional[Any]):
    """The partition mesh a query runs under: none, ``mesh`` lanes (an
    int), or the given ``PartitionMesh``."""
    from ..runtime import spmd as _sp
    if mesh is None:
        return contextlib.nullcontext()
    if isinstance(mesh, int) and not isinstance(mesh, bool):
        return _sp.use_partition_mesh(mesh)
    return _sp.use_partition_mesh(mesh=mesh)


def run_query(plan, datasets: Dict[str, PartitionedDataset],
              catalog: Optional[Catalog] = None,
              config: RewriteConfig = RewriteConfig(),
              vectorize: bool = False,
              snapshot: bool = False,
              mesh: Optional[Any] = None
              ) -> Tuple[Rows, "Executor"]:
    """Optimize a LogicalOp plan and execute it.  Returns (rows, executor)
    — the executor carries connector/operator statistics.  With
    ``vectorize=True`` supported subplans run on the columnar engine.
    With ``snapshot=True`` every dataset that supports ``pin()`` is
    pinned for the duration of the query, so the whole plan executes
    against one consistent LSM state even while concurrent writers are
    ingesting (snapshot isolation; pins are released on return).  With
    ``mesh`` (a ``runtime.spmd.PartitionMesh``, or an int: that many
    partition lanes on the one device) the columnar engine's
    per-partition loops run as single stacked dispatches over the
    partition lanes (``runtime/spmd``); results are bit-identical to the
    loop's."""
    if catalog is None:
        catalog = _default_catalog(datasets)
    phys = optimize(plan, catalog, config)
    pinned = []
    exec_datasets = datasets
    if snapshot:
        exec_datasets = {}
        for n, ds in datasets.items():
            if hasattr(ds, "pin") and not isinstance(ds, DatasetSnapshot):
                snap = ds.pin()
                pinned.append(snap)
                exec_datasets[n] = snap
            else:
                exec_datasets[n] = ds
    try:
        from ..columnar import plancache as _pc
        from ..kernels import columnar_ops as K
        from ..runtime import spmd as _sp
        with _mesh_context(mesh):
            ex = Executor(exec_datasets, vectorize=vectorize)
            traces0 = K.trace_count()
            kt0 = _obs.kernel_totals()
            pc0 = _pc.totals()
            sp0 = _sp.dispatch_totals()
            parts = ex.execute_op(phys)
            _finish_stats(ex, traces0, kt0, pc0, sp0)
            rows = [r for p in parts for r in p]
            return rows, ex
    finally:
        for snap in pinned:
            snap.release()


def _annotate(op: PhysicalOp, analysis: Dict[int, Dict[str, Any]]
              ) -> Dict[str, Any]:
    """Physical plan tree -> annotated dict tree.  Measured nodes carry
    inclusive values plus ``self_*`` exclusives (inclusive minus measured
    direct children); nodes executed inside a fused columnar closure
    carry whatever per-stage numbers the closure recorded."""
    children = [_annotate(c, analysis) for c in op.children]
    node: Dict[str, Any] = {"op": op.kind,
                            "connectors": [c.name for c in op.connectors]}
    e = analysis.get(id(op))
    if e is None:
        node["mode"] = "fused"      # ran inside an ancestor's closure
    else:
        node.update({kk: v for kk, v in e.items() if kk != "op"})
        if "wall_s" in e:           # measured (not a fused-stage entry)
            for key in ("wall_s", "rows_moved", "kernel_dispatches",
                        "h2d_bytes", "d2h_bytes"):
                node["self_" + key] = e[key] - sum(
                    c.get(key, 0) for c in children)
            node["rows_in"] = sum(c.get("rows_out", 0) for c in children)
    node["children"] = children
    return node


def explain_analyze(plan, datasets: Dict[str, PartitionedDataset],
                    catalog: Optional[Catalog] = None,
                    config: RewriteConfig = RewriteConfig(),
                    vectorize: bool = True,
                    mesh: Optional[Any] = None) -> Dict[str, Any]:
    """EXPLAIN ANALYZE: optimize, execute, and return the physical plan
    annotated per operator with wall time, rows in/out, connector rows
    moved, lowering outcome (columnar / fused / fallback+reason / row),
    kernel dispatches, and host<->device transfer bytes.

    Returns ``{"rows", "plan", "totals", "stats"}``: ``rows`` is the
    query result, ``plan`` the annotated operator tree (``self_*`` keys
    are per-operator exclusive values; plain keys are subtree-inclusive),
    ``totals`` the whole-query wall time and kernel traffic, ``stats``
    the executor's ExecStats.  Combine with ``obs.enable()`` +
    ``obs.dump_trace(path)`` for the same run on a Chrome-trace timeline.
    """
    if catalog is None:
        catalog = _default_catalog(datasets)
    phys = optimize(plan, catalog, config)
    ex = Executor(datasets, vectorize=vectorize)
    ex.analysis = {}
    ex._fallback_reasons = {}
    from ..columnar import plancache as _pc
    from ..kernels import columnar_ops as K
    from ..runtime import spmd as _sp
    ctx = _mesh_context(mesh)
    traces0 = K.trace_count()
    kt0 = _obs.kernel_totals()
    pc0 = _pc.totals()
    sp0 = _sp.dispatch_totals()
    t0 = time.perf_counter()
    with ctx:
        parts = ex.execute_op(phys)
    wall = time.perf_counter() - t0
    _finish_stats(ex, traces0, kt0, pc0, sp0)
    rows = [r for p in parts for r in p]
    return {
        "rows": rows,
        "plan": _annotate(phys, ex.analysis),
        "totals": {
            "wall_s": wall,
            "rows": len(rows),
            "kernel_dispatches": ex.stats.kernel_dispatches,
            "h2d_bytes": ex.stats.h2d_bytes,
            "d2h_bytes": ex.stats.d2h_bytes,
            "kernel_retraces": ex.stats.kernel_retraces,
            "plan_cache_hits": ex.stats.plan_cache_hits,
            "plan_cache_misses": ex.stats.plan_cache_misses,
            "spmd_dispatches": ex.stats.spmd_dispatches,
            "spmd_partitions": ex.stats.spmd_partitions,
        },
        "stats": ex.stats,
    }
