"""Lowers supported PhysicalOp subplans to columnar pipelines.

``storage/query.Executor(vectorize=True)`` calls ``try_lower`` on every
operator before falling back to row-at-a-time execution.  A successful
lowering executes the whole subtree on ColumnBatches — connectors
included (hash repartitioning is placement-identical to the row engine's
``hash_partition``) — and converts back to row dicts only at the
boundary.  Unsupported operators (index access paths, opaque predicates
without sargable ranges, exotic aggregate/kind combos) return None and
the row engine runs them; their *children* still get their own chance to
vectorize.

Lowered operator set:

  DATASET_SCAN            per-component column projection scan
  STREAM_SELECT           sargable ranges (+ residual pred re-check
                          unless the plan declared ``ranges_exact``)
  POST_VALIDATE_SELECT /
  PRIMARY_INDEX_LOOKUP    Figure-6 index access chains (secondary btree /
                          rtree / keyword search -> SORT_PK -> primary
                          lookup [-> post-validate]): each partition's
                          per-component CSR postings probe yields a
                          candidate position bitmap over the primary's
                          cached ColumnBatches directly (datasets exposing
                          only sorted candidate-PK arrays go through the
                          fused sorted-intersection kernel instead);
                          multi-index conjunctions AND bitmaps before any
                          record decode, and post-validation runs on the
                          gathered columns.  The fuzzy chains (NGRAM_INDEX_SEARCH
                          -> T_OCCURRENCE -> same tail) produce the bitmap
                          straight from the ngram postings' T-occurrence
                          count kernel and verify candidates with the
                          batched similarity kernels (fuzzy/verify)
  STREAM_PROJECT          column projection
  LOCAL_AGG/GLOBAL_AGG    fused filter+aggregate kernel when the child
                          is an exact-range select
  LOCAL_PREAGG/HASH_GROUP/GLOBAL_GROUP   vectorized grouped aggregation
  LOCAL_SORT/SORT_MERGE_GATHER/LOCAL_TOPK/TOPK_MERGE/STREAM_LIMIT
  HYBRID_HASH_JOIN        int/str/f64-domain equality keys

Every lowered operator records its cardinality in ``ExecStats.op_rows``
(same keys as the row engine) plus ``rows_vectorized``; index-path
operators additionally count into ``rows_index_vectorized``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..core.algebra import Connector, PhysicalOp
from .. import obs as _obs
from ..runtime import spmd as SP
from . import operators as O
from .batch import ColumnBatch

__all__ = ["try_lower", "Unsupported"]

# node() -> per-partition batches
Node = Callable[[], List[ColumnBatch]]


class Unsupported(Exception):
    """This subplan stays on the row engine."""


def _columnar_dataset(ex: Any, name: str, index: bool = False,
                      fuzzy: bool = False) -> Any:
    """The one capability probe for columnar dataset access: the named
    dataset must expose the columnar scan surface (plus the candidate-PK
    index surface when ``index``, plus the ngram candidate-bitmap surface
    when ``fuzzy``), else the subplan stays on the row engine."""
    ds = ex.datasets.get(name)
    if ds is None or not hasattr(ds, "scan_partition_batch"):
        raise Unsupported("dataset has no columnar scan")
    if index and not (hasattr(ds, "partition_pk_array")
                      and (hasattr(ds, "secondary_candidate_mask")
                           or hasattr(ds, "secondary_candidate_pks"))):
        raise Unsupported("dataset has no columnar index access")
    if fuzzy and not hasattr(ds, "ngram_candidate_mask"):
        raise Unsupported("dataset has no ngram candidate access")
    return ds


_VECTOR_COMPUTE = {
    "STREAM_SELECT", "LOCAL_AGG", "GLOBAL_AGG", "LOCAL_PREAGG",
    "HASH_GROUP", "GLOBAL_GROUP", "LOCAL_SORT", "SORT_MERGE_GATHER",
    "LOCAL_TOPK", "TOPK_MERGE", "HYBRID_HASH_JOIN",
    "POST_VALIDATE_SELECT", "PRIMARY_INDEX_LOOKUP",
}

_INDEX_SEARCHES = {"SECONDARY_INDEX_SEARCH", "SPATIAL_INDEX_SEARCH",
                   "KEYWORD_INDEX_SEARCH", "NGRAM_INDEX_SEARCH"}


def _decline(ex: Any, op: PhysicalOp, reason: str) -> None:
    """Record why this subplan stays on the row engine: always into
    ``ExecStats.fallback_reasons`` (queryable by the differential
    harness), and per-node for ``explain_analyze`` when active."""
    ex.stats.fell_back(op.kind, reason)
    reasons = getattr(ex, "_fallback_reasons", None)
    if reasons is not None:
        reasons[id(op)] = reason


def try_lower(op: PhysicalOp, ex: Any) -> Optional[Callable[[], list]]:
    """Compile ``op``'s subtree to a columnar pipeline, or None.  The
    returned callable yields the row engine's row Parts up to row order
    inside unordered operators (grouped/joined row order may be permuted;
    sorts, top-k and limits are order-exact).  A None return always
    leaves its reason in ``ex.stats.fallback_reasons``."""
    if not _profitable(op):
        _decline(ex, op, "not profitable (no vectorized compute)")
        return None
    if op.kind == "HYBRID_HASH_JOIN":
        # a join at the pipeline root materializes its full output as row
        # dicts at the boundary, which costs more than the row engine's
        # dict merge; joins vectorize only under a reducing operator
        # (aggregate/group/top-k), where the output never widens to rows
        _decline(ex, op, "join at pipeline root")
        return None
    try:
        node = _compile(op, ex, None)
    except Unsupported as e:
        _decline(ex, op, str(e))
        return None

    def run() -> list:
        with _obs.span("columnar." + op.kind):
            return [b.to_rows() for b in node()]
    return run


def _profitable(op: PhysicalOp) -> bool:
    """A pipeline that only scans/projects/limits would pay shred+decode
    for nothing; require at least one vectorized compute operator."""
    if op.kind in _VECTOR_COMPUTE:
        return True
    return any(_profitable(c) for c in op.children)


def _check_aggs(aggs: Dict[str, Tuple[str, str]]) -> None:
    for name, (fn, _col) in aggs.items():
        if fn not in O._AGG_FNS:
            raise Unsupported(f"aggregate {fn}")


def _empty(n: int) -> List[ColumnBatch]:
    return [ColumnBatch({}, 0) for _ in range(n)]


def _total(cparts: Sequence[ColumnBatch]) -> int:
    return sum(len(b) for b in cparts)


def _apply_conn(conn: Connector, cparts: List[ColumnBatch], ex: Any,
                p: int) -> List[ColumnBatch]:
    import numpy as np
    if conn.name == "OneToOne":
        return cparts
    if conn.name in ("MToNHashPartition", "MToNHashPartitionMerge"):
        # on an active partition mesh the repartition lowers to one tiled
        # all_to_all per column plane (placement- and order-identical to
        # the host bucketing below); host path covers string/obj schemas
        # whose dictionary codes are partition-local
        exg = SP.exchange_batches(cparts, conn.keys, p)
        if exg is not None:
            out, moved = exg
            if conn.name == "MToNHashPartitionMerge" and conn.sort_keys:
                out = [O.sort_batch(b, conn.sort_keys, False) for b in out]
            ex.stats.moved(conn.name, moved)
            return out
        buckets: List[List[ColumnBatch]] = [[] for _ in range(p)]
        moved = 0
        for i, b in enumerate(cparts):
            if not len(b):
                continue
            ids = O.partition_ids(b, conn.keys, p)
            moved += int((ids != i).sum())
            for j in range(p):
                sel = ids == j
                if sel.any():
                    buckets[j].append(b.filter(sel))
        out = [ColumnBatch.concat(bs) if bs else ColumnBatch({}, 0)
               for bs in buckets]
        if conn.name == "MToNHashPartitionMerge" and conn.sort_keys:
            out = [O.sort_batch(b, conn.sort_keys, False) for b in out]
        ex.stats.moved(conn.name, moved)
        return out
    if conn.name == "MToNReplicate":
        allb = O.concat_gather(cparts)
        ex.stats.moved(conn.name, len(allb) * (p - 1))
        return [allb for _ in range(p)]
    if conn.name == "ReplicateToOne":
        ex.stats.moved(conn.name, sum(len(b) for b in cparts[1:]))
        return [O.concat_gather(cparts)] + _empty(p - 1)
    raise Unsupported(conn.name)


def _agg_out_cols(aggs: Dict[str, Tuple[str, str]]) -> Set[str]:
    return {c for (_fn, c) in aggs.values() if c != "*"}


def _compile(op: PhysicalOp, ex: Any, needed: Optional[Set[str]]) -> Node:
    k = op.kind
    p = ex.num_partitions
    attrs = op.attrs

    if k == "DATASET_SCAN":
        ds = _columnar_dataset(ex, attrs["dataset"])
        cols = None if needed is None else sorted(needed)

        def run_scan():
            cparts = [ds.scan_partition_batch(i, cols)
                      for i in range(ds.num_partitions)]
            cparts += _empty(p - ds.num_partitions)
            ex.stats.vectorized(k, _total(cparts))
            return cparts
        return run_scan

    if k == "STREAM_SELECT":
        ranges = attrs.get("ranges") or {}
        if not ranges:
            raise Unsupported("opaque predicate (no sargable ranges)")
        pred = attrs.get("pred")
        residual = not attrs.get("ranges_exact", False)
        child_needed = None if residual else (
            None if needed is None else needed | set(ranges))
        child = _compile(op.children[0], ex, child_needed)
        conn = op.connectors[0]

        def run_select():
            cparts = child()
            cparts = _apply_conn(conn, cparts, ex, p)
            # SPMD: every partition's range mask in one stacked
            # dispatch; None entries (empty batch / absent column) and a
            # None return (no mesh, operand drift) keep the loop path
            masks = SP.batched_range_masks(cparts, ranges)
            out = [O.select_batch_with_mask(b, masks[i], pred, residual)
                   if masks is not None and masks[i] is not None
                   else O.select_batch(b, ranges, pred, residual)
                   for i, b in enumerate(cparts)]
            ex.stats.vectorized(k, _total(out))
            return out
        return run_select

    if k in ("POST_VALIDATE_SELECT", "PRIMARY_INDEX_LOOKUP"):
        return _compile_index_path(op, ex, needed, p)

    if k == "STREAM_PROJECT":
        cols = tuple(attrs["cols"])
        child = _compile(op.children[0], ex, set(cols))
        conn = op.connectors[0]

        def run_project():
            cparts = child()
            cparts = _apply_conn(conn, cparts, ex, p)
            out = [b.project(cols) for b in cparts]
            ex.stats.vectorized(k, _total(out))
            return out
        return run_project

    if k == "LOCAL_AGG":
        aggs = attrs["aggs"]
        _check_aggs(aggs)
        child_op = op.children[0]
        conn = op.connectors[0]
        # fusion: exact-range select directly below the aggregate runs as
        # one filter+reduce kernel pass per partition
        fuse = (child_op.kind == "STREAM_SELECT"
                and bool(child_op.attrs.get("ranges"))
                and bool(child_op.attrs.get("ranges_exact")))
        if fuse:
            ranges = child_op.attrs["ranges"]
            inner = _compile(child_op.children[0], ex,
                             _agg_out_cols(aggs) | set(ranges))
            sel_conn = child_op.connectors[0]

            def run_fused_agg():
                cparts = inner()
                cparts = _apply_conn(sel_conn, cparts, ex, p)
                # SPMD: all partitions' filter+reduce as one stacked
                # dispatch; per-partition None entries (and a None
                # return) keep the per-partition kernel path
                batched = SP.batched_select_aggregate(cparts, ranges, aggs)
                out, survivors = [], 0
                for i, b in enumerate(cparts):
                    r = batched[i] if batched is not None else None
                    if r is None:
                        r = O.fused_select_aggregate(b, ranges, aggs,
                                                     partial=True)
                    if r is None:
                        sb = O.select_batch(b, ranges,
                                            child_op.attrs.get("pred"),
                                            residual=False)
                        r = O.aggregate_batch(sb, aggs, partial=True)
                    row, surv = r
                    survivors += surv
                    out.append(ColumnBatch.from_rows([row]))
                ex.stats.vectorized("STREAM_SELECT", survivors)
                ex.stats.vectorized(k, len(out))
                analysis = getattr(ex, "analysis", None)
                if analysis is not None:
                    analysis[id(child_op)] = {"op": "STREAM_SELECT",
                                              "mode": "fused",
                                              "rows_out": survivors}
                out = _apply_conn(conn, out, ex, p)
                return out
            return run_fused_agg
        # a secondary-index chain directly below the aggregate compiles
        # into the fused whole-chain dispatch (probe -> bitmap -> filter
        # -> reduce as one plan-cached kernel; columnar/plancache) with
        # the per-operator chain as its partitionwise fallback
        if child_op.kind in ("POST_VALIDATE_SELECT",
                             "PRIMARY_INDEX_LOOKUP") \
                and conn.name == "OneToOne":
            try:
                inner = _compile_index_path(child_op, ex,
                                            _agg_out_cols(aggs) or None,
                                            p, aggs=aggs)
            except Unsupported:
                inner = None
            if inner is not None:
                def run_index_agg():
                    out = inner()
                    ex.stats.vectorized(k, len(out))
                    return _apply_conn(conn, out, ex, p)
                return run_index_agg
        child = _compile(child_op, ex, _agg_out_cols(aggs) or None)

        def run_local_agg():
            cparts = child()
            cparts = _apply_conn(conn, cparts, ex, p)
            out = []
            for b in cparts:
                row, _surv = O.aggregate_batch(b, aggs, partial=True)
                out.append(ColumnBatch.from_rows([row]))
            ex.stats.vectorized(k, len(out))
            return out
        return run_local_agg

    if k == "GLOBAL_AGG":
        aggs = attrs["aggs"]
        _check_aggs(aggs)
        child = _compile(op.children[0], ex, None)
        conn = op.connectors[0]

        def run_global_agg():
            from ..storage.query import _agg_merge, _agg_row
            cparts = child()
            cparts = _apply_conn(conn, cparts, ex, p)
            rows = [r for b in cparts for r in b.to_rows()]
            merged = _agg_merge(rows, aggs) if rows \
                else _agg_row([], aggs, partial=False)
            out = [ColumnBatch.from_rows([merged])] + _empty(p - 1)
            ex.stats.vectorized(k, 1)
            return out
        return run_global_agg

    if k in ("LOCAL_PREAGG", "HASH_GROUP", "GLOBAL_GROUP"):
        keys = tuple(attrs["keys"])
        aggs = attrs["aggs"]
        _check_aggs(aggs)
        mode = {"LOCAL_PREAGG": "partial", "HASH_GROUP": "final",
                "GLOBAL_GROUP": "merge"}[k]
        child_needed = None if mode == "merge" \
            else set(keys) | _agg_out_cols(aggs)
        child = _compile(op.children[0], ex, child_needed)
        conn = op.connectors[0]

        def run_group():
            cparts = child()
            cparts = _apply_conn(conn, cparts, ex, p)
            out = [O.group_aggregate(b, keys, aggs, mode)
                   for b in cparts]
            ex.stats.vectorized(k, _total(out))
            return out
        return run_group

    if k in ("LOCAL_SORT", "LOCAL_TOPK"):
        keys = tuple(attrs["keys"])
        desc = attrs.get("desc", False)
        limit = attrs.get("n") if k == "LOCAL_TOPK" else None
        child_needed = None if needed is None else needed | set(keys)
        child = _compile(op.children[0], ex, child_needed)
        conn = op.connectors[0]

        def run_local_sort():
            cparts = child()
            cparts = _apply_conn(conn, cparts, ex, p)
            out = [O.sort_batch(b, keys, desc, limit) for b in cparts]
            ex.stats.vectorized(k, _total(out))
            return out
        return run_local_sort

    if k in ("SORT_MERGE_GATHER", "TOPK_MERGE"):
        keys = tuple(attrs["keys"])
        desc = attrs.get("desc", False)
        limit = attrs.get("n") if k == "TOPK_MERGE" else None
        child_needed = None if needed is None else needed | set(keys)
        child = _compile(op.children[0], ex, child_needed)
        conn = op.connectors[0]

        def run_merge_sort():
            cparts = child()
            cparts = _apply_conn(conn, cparts, ex, p)
            out = [O.sort_batch(cparts[0], keys, desc, limit)] \
                + list(cparts[1:])
            ex.stats.vectorized(k, _total(out))
            return out
        return run_merge_sort

    if k == "STREAM_LIMIT":
        n = attrs["n"]
        child = _compile(op.children[0], ex, needed)
        conn = op.connectors[0]

        def run_limit():
            cparts = child()
            cparts = _apply_conn(conn, cparts, ex, p)
            out = [b.slice(n) for b in cparts]
            ex.stats.vectorized(k, _total(out))
            return out
        return run_limit

    if k == "HYBRID_HASH_JOIN":
        lk, rk = tuple(attrs["lkeys"]), tuple(attrs["rkeys"])
        lneeded = None if needed is None else needed | set(lk)
        rneeded = None if needed is None else needed | set(rk)
        left = _compile(op.children[0], ex, lneeded)
        right = _compile(op.children[1], ex, rneeded)
        lconn, rconn = op.connectors

        def run_join():
            lparts = left()
            rparts = right()
            lparts = _apply_conn(lconn, lparts, ex, p)
            rparts = _apply_conn(rconn, rparts, ex, p)
            out = [O.join_batches(lb, rb, lk, rk)
                   for lb, rb in zip(lparts, rparts)]
            ex.stats.vectorized(k, _total(out))
            return out
        return run_join

    raise Unsupported(k)


# ---------------------------------------------------------------------------
# index access paths (the Figure-6 chain, vectorized)
# ---------------------------------------------------------------------------

def _chain_child(op: PhysicalOp, kind: str) -> PhysicalOp:
    """The chain's edges are all OneToOne (R2 keeps secondary lookups
    node-local); anything else stays on the row engine."""
    if len(op.children) != 1 or op.connectors[0].name != "OneToOne":
        raise Unsupported(f"{op.kind} connector")
    child = op.children[0]
    if child.kind != kind:
        raise Unsupported(f"{op.kind} over {child.kind}")
    return child


def _pk_intersect_mask(ds: Any, i: int, cands) -> Optional[Any]:
    """Legacy candidate-PK surface -> position bitmap via the fused
    sorted-intersection kernel (datasets without the bitmap surface)."""
    if not len(cands):
        return None
    keys = ds.partition_pk_array(i)
    if not len(keys):
        return None
    return O.candidate_position_mask(keys, cands)


def _search_mask(ds: Any, i: int, search: PhysicalOp):
    """Candidate position bitmap of the chain's own index search on one
    partition (None: provably empty).  Datasets exposing the per-
    component postings surface produce the bitmap straight from CSR
    probes (searchsorted range slice / segment gather + one scatter);
    the PK-array surface falls back to sorted-intersection."""
    a = search.attrs
    if search.kind == "SECONDARY_INDEX_SEARCH":
        if hasattr(ds, "secondary_candidate_mask"):
            return ds.secondary_candidate_mask(i, a["field"], a["lo"],
                                               a["hi"])
        return _pk_intersect_mask(
            ds, i, ds.secondary_candidate_pks(i, a["field"], a["lo"],
                                              a["hi"]))
    if search.kind == "SPATIAL_INDEX_SEARCH":
        center, radius = a["args"]
        if hasattr(ds, "spatial_candidate_mask"):
            return ds.spatial_candidate_mask(i, a["field"], center, radius)
        return _pk_intersect_mask(
            ds, i, ds.spatial_candidate_pks(i, a["field"], center, radius))
    token, fuzzy_ed = a["args"]
    if hasattr(ds, "keyword_candidate_mask"):
        return ds.keyword_candidate_mask(i, a["field"], token, fuzzy_ed)
    return _pk_intersect_mask(
        ds, i, ds.keyword_candidate_pks(i, a["field"], token, fuzzy_ed))


def _range_mask(ds: Any, i: int, f: str, lo: Any, hi: Any):
    """One extra btree-indexed range field's candidate bitmap (multi-
    index conjunction)."""
    if hasattr(ds, "secondary_candidate_mask"):
        return ds.secondary_candidate_mask(i, f, lo, hi)
    return O.candidate_position_mask(
        ds.partition_pk_array(i), ds.secondary_candidate_pks(i, f, lo, hi))


def _compile_index_path(op: PhysicalOp, ex: Any,
                        needed: Optional[Set[str]], p: int,
                        aggs: Optional[Dict[str, Tuple[str, str]]] = None
                        ) -> Node:
    """Lower POST_VALIDATE_SELECT <- PRIMARY_INDEX_LOOKUP <- SORT_PK <-
    {SECONDARY,SPATIAL,KEYWORD}_INDEX_SEARCH onto the columnar engine:
    each partition's search yields a candidate position bitmap straight
    from the per-component CSR postings (searchsorted over the sorted
    key dictionary -> gathered position segments -> one scatter pass,
    composed with the newest-wins live selection; every additional
    btree-indexed range field contributes another bitmap, ANDed in
    before any gather), and the surviving positions gather the cached
    columns for post-validation — no (key, pk) pair is ever walked and
    no row dict is materialized for a non-matching candidate.  Datasets
    exposing only sorted candidate-PK arrays keep the fused
    sorted-intersection kernel path.

    The fuzzy variant (SORT_PK <- T_OCCURRENCE <- NGRAM_INDEX_SEARCH)
    joins the same pipeline one step earlier: the ngram T-occurrence
    kernel produces the position bitmap *directly* (postings store row
    positions, so no PK intersection is needed), conjunctions AND in
    exactly as above, and the VERIFY stage replaces the row-at-a-time
    predicate with the batched similarity kernels over the gathered
    column's dictionary (``fuzzy.verify.verify_mask``).  Chain rows count
    into ``ExecStats.rows_fuzzy_vectorized``."""
    if op.kind == "POST_VALIDATE_SELECT":
        validate: Optional[PhysicalOp] = op
        lookup = _chain_child(op, "PRIMARY_INDEX_LOOKUP")
    else:
        validate, lookup = None, op
    sort = _chain_child(lookup, "SORT_PK")
    search = sort.children[0] if len(sort.children) == 1 else None
    tocc = None
    if search is not None and search.kind == "T_OCCURRENCE":
        tocc = search
        search = _chain_child(search, "NGRAM_INDEX_SEARCH")
    if search is None or search.kind not in _INDEX_SEARCHES \
            or sort.connectors[0].name != "OneToOne":
        raise Unsupported("SORT_PK without an index search below")
    is_fuzzy = search.kind == "NGRAM_INDEX_SEARCH"
    ds = _columnar_dataset(ex, lookup.attrs["dataset"], index=True,
                           fuzzy=is_fuzzy)
    if search.attrs["dataset"] != lookup.attrs["dataset"]:
        raise Unsupported("index search against a different dataset")

    ranges = dict(validate.attrs.get("ranges") or {}) if validate else {}
    pred = validate.attrs.get("pred") if validate else None
    fields = tuple(validate.attrs.get("fields", ())) if validate else ()
    residual = not (validate.attrs.get("ranges_exact", False)
                    if validate else True)
    fuzzy_spec = search.attrs.get("spec") if is_fuzzy else None
    if is_fuzzy:
        # verification uses the *spec's* gram length (the predicate's
        # semantics); the index's gram_length only shapes the candidate
        # postings.  Like every other access path, the full pred
        # re-checks the gathered survivors unless the plan declared
        # ``ranges_exact`` (pred may carry conjuncts beyond the spec).
        from ..fuzzy.ngram import spec_gram_length
        gram_k = spec_gram_length(fuzzy_spec)
    else:
        gram_k = 3
    # fields names exactly what pred reads, so projected gathers stay safe
    # even when a range column degrades to a row-at-a-time re-check
    fz_cols = {fuzzy_spec[0]} if fuzzy_spec is not None else set()
    cols = None if needed is None \
        else sorted(set(needed) | set(ranges) | set(fields) | fz_cols)
    # multi-index conjunction: every other btree-indexed range field adds
    # a candidate bitmap of its own
    search_field = search.attrs.get("field")
    extra_fields = tuple(
        f for f in ranges
        if f != search_field
        and getattr(ds, "index_kinds", {}).get(f) == "btree")
    # ranges already guaranteed by a candidate bitmap (the index holds the
    # row's *current* value, so live entries are never stale here) need no
    # vectorized re-check; only non-indexed range fields remain
    validate_ranges = dict(ranges)
    for f in extra_fields:
        validate_ranges.pop(f, None)
    if search.kind == "SECONDARY_INDEX_SEARCH" \
            and search_field in validate_ranges \
            and tuple(validate_ranges[search_field]) == \
                (search.attrs["lo"], search.attrs["hi"]):
        validate_ranges.pop(search_field)

    if aggs is not None and is_fuzzy:
        raise Unsupported("fuzzy aggregate chain")   # generic path handles
    # whole-chain fused dispatch (columnar/plancache): compiled once per
    # plan shape, runs the probe -> AND -> filter (-> reduce) pipeline as
    # one kernel over pooled device buffers.  Partitions it declines fall
    # through to the per-operator path below — results are identical.
    fused = None
    if not is_fuzzy and search.kind == "SECONDARY_INDEX_SEARCH":
        from . import plancache as PC
        chain_ops = (search.kind, "SORT_PK", "PRIMARY_INDEX_LOOKUP") \
            + (("POST_VALIDATE_SELECT",) if validate is not None else ()) \
            + (("LOCAL_AGG",) if aggs is not None else ())
        fused = PC.compile_chain(
            ds, chain_ops=chain_ops, search_field=search_field,
            search_bounds=(search.attrs["lo"], search.attrs["hi"]),
            extra=[(f,) + tuple(ranges[f]) for f in extra_fields],
            validate_ranges=validate_ranges, pred=pred,
            residual=residual, fields=fields, aggs=aggs)

    def run_index_path():
        from ..fuzzy.verify import verify_mask
        stat = ex.stats.fuzzy_vectorized if is_fuzzy \
            else ex.stats.index_vectorized
        out: List[ColumnBatch] = []
        n_cand = n_found = n_valid = 0
        empty_row = None
        if aggs is not None:
            from . import plancache as PC
            # what LOCAL_AGG yields for an empty / padding partition
            empty_row = PC.empty_partition_agg(aggs)

        def emit_empty():
            out.append(ColumnBatch.from_rows([dict(empty_row)])
                       if aggs is not None else ColumnBatch({}, 0))

        # SPMD: all partitions' fused chains as one stacked
        # dispatch over the active mesh (plancache.run_all); a None
        # return or per-partition None entries keep the loop below
        spmd_res = fused.run_all(cols) if fused is not None else None
        for i in range(ds.num_partitions):
            if spmd_res is not None:
                res = spmd_res[i]      # None: legacy path, same as loop
            else:
                res = fused(i, cols) if fused is not None else None
            if res is not None:
                n_cand += res.n_cand
                n_found += res.n_found
                n_valid += res.n_valid
                out.append(ColumnBatch.from_rows([res.row])
                           if aggs is not None else res.batch)
                continue
            if is_fuzzy:
                # T-occurrence candidate bitmap, already position-aligned
                # with the partition's scan batch — no PK intersection
                mask = ds.ngram_candidate_mask(i, search.attrs["field"],
                                               fuzzy_spec)
                n_cand += int(mask.sum())
                if not mask.any():
                    emit_empty()                 # no candidates
                    continue
            else:
                mask = _search_mask(ds, i, search)
                if mask is None or not mask.any():
                    emit_empty()                 # short-circuit: no scan
                    continue
                n_cand += int(mask.sum())
            for f in extra_fields:
                if not mask.any():
                    break
                lo, hi = ranges[f]
                mask = mask & _range_mask(ds, i, f, lo, hi)
            if not mask.any():
                emit_empty()                     # empty intersection
                continue
            n_found += int(mask.sum())           # live candidates gathered
            batch = ds.scan_partition_batch(i, cols)
            if fuzzy_spec is not None and validate is not None:
                # VERIFY: batched similarity kernels over the candidate
                # positions' dictionary-coded column (per distinct value)
                mask = verify_mask(batch, mask, fuzzy_spec, gram_k)
            if validate is not None and (validate_ranges
                                         or (residual and pred is not None)):
                got = O.index_post_validate(batch, mask, validate_ranges,
                                            pred, residual, fields)
            else:
                got = batch.filter(mask)
            n_valid += len(got)
            if aggs is not None:
                row, _surv = O.aggregate_batch(got, aggs, partial=True)
                out.append(ColumnBatch.from_rows([row]))
            else:
                out.append(got)
        if aggs is not None:
            for _ in range(p - ds.num_partitions):
                emit_empty()
        else:
            out += _empty(p - ds.num_partitions)
        stat(search.kind, n_cand)
        if is_fuzzy:
            stat("T_OCCURRENCE", n_cand)
        stat("SORT_PK", n_cand)
        stat("PRIMARY_INDEX_LOOKUP", n_found)
        if validate is not None:
            stat("POST_VALIDATE_SELECT", n_valid)
        analysis = getattr(ex, "analysis", None)
        if analysis is not None:
            # per-stage cardinalities for explain_analyze: the chain runs
            # as one fused closure, so its inner ops never see execute_op
            entries = [(search, n_cand), (sort, n_cand), (lookup, n_found)]
            if tocc is not None:
                entries.insert(1, (tocc, n_cand))
            if validate is not None:
                entries.append((validate, n_valid))
            for chain_op, n in entries:
                analysis[id(chain_op)] = {"op": chain_op.kind,
                                          "mode": "fused", "rows_out": n}
        return out
    return run_index_path
