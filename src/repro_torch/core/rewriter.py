"""Rule-based plan rewriter (paper §4.2 Algebricks, §5.1 "safe rules").

The paper: "it has a set of fairly sophisticated but 'safe' rules to determine
the general shape of a physical query plan and its parallelization and data
movement.  The optimizer keeps track of data partitioning and only moves data
as changes in parallelism or partitioning require.  (a) AsterixDB always
chooses index-based access for selections if an index is available and (b) it
always chooses parallel hash-joins for equijoins", with hints to override.

Implemented rules (applied in order, single pass — the rule set is confluent
by construction like Algebricks' rule collections):

  R1 select-pushdown        push SELECT below JOIN when one-sided
  R2 index-access-path      SELECT(sargable) over SCAN -> secondary-index
                            search + SORT(pk) + primary lookup + POST-VALIDATE
                            (Figure 6's plan, incl. the post-validation select
                            required by LSM secondary-index consistency §4.4).
                            Fuzzy selects (edit-distance / Jaccard specs) take
                            the ngram variant: NGRAM_INDEX_SEARCH ->
                            T_OCCURRENCE -> the same SORT/LOOKUP/VALIDATE tail
  R3 join-method            equijoin -> HYBRID_HASH_JOIN with hash-partition
                            connectors; hint "indexnl" -> INDEX_NL_JOIN
  R4 agg-split              AGG -> LOCAL_AGG ->ReplicateToOne-> GLOBAL_AGG
                            GROUPBY -> LOCAL_PREAGG ->HashPartition(keys)->
                            GLOBAL_GROUP  (Figure 6's local/global split)
  R5 limit-into-sort        ORDERBY+LIMIT -> per-partition TOPK + merge.
                            *Beyond paper*: §5.3.2 notes "AsterixDB does not
                            push limits into sort operations yet"; we do,
                            guarded by `push_limit_into_sort` (default on).
  R6 exchange-insertion     insert the minimal Connector wherever required
                            partitioning != delivered partitioning
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .algebra import (
    Connector, LogicalOp, MToNHashPartition, MToNHashPartitionMerge,
    MToNReplicate, ONE_TO_ONE, Partitioning, PhysicalOp, RANDOM,
    ReplicateToOne, SINGLETON, hash_partitioned, ReplicateToOne,
)

__all__ = ["Catalog", "IndexInfo", "RewriteConfig", "optimize", "explain"]


@dataclass(frozen=True)
class IndexInfo:
    name: str
    dataset: str
    field: str
    kind: str = "btree"   # btree | rtree | keyword | ngram
    gram_length: int = 3  # ngram(k) only: the k the postings were built with


@dataclass
class Catalog:
    """What the optimizer knows: datasets, their primary keys, partition
    counts, and secondary indexes (paper §2.2)."""

    primary_keys: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    indexes: List[IndexInfo] = field(default_factory=list)
    num_partitions: int = 1

    def index_on(self, dataset: str, fld: str) -> Optional[IndexInfo]:
        for ix in self.indexes:
            if ix.dataset == dataset and ix.field == fld:
                return ix
        return None


@dataclass(frozen=True)
class RewriteConfig:
    use_indexes: bool = True            # paper rule (a)
    hash_join: bool = True              # paper rule (b)
    push_limit_into_sort: bool = True   # beyond-paper (paper §5.3.2 lacks it)
    split_aggregation: bool = True      # Figure 6 local/global split


# ---------------------------------------------------------------------------
# R1: select pushdown through joins
# ---------------------------------------------------------------------------

def _r1_select_pushdown(op: LogicalOp) -> LogicalOp:
    op = op.replace_children([_r1_select_pushdown(c) for c in op.children]) \
        if op.children else op
    if op.kind == "SELECT" and op.children[0].kind == "JOIN":
        jn = op.children[0]
        fields = set(op.attrs["fields"])
        lcols = _visible_columns(jn.children[0])
        rcols = _visible_columns(jn.children[1])
        if lcols is not None and fields <= lcols:
            newl = LogicalOp("SELECT", (jn.children[0],), dict(op.attrs))
            return jn.replace_children([newl, jn.children[1]])
        if rcols is not None and fields <= rcols:
            newr = LogicalOp("SELECT", (jn.children[1],), dict(op.attrs))
            return jn.replace_children([jn.children[0], newr])
    return op


def _visible_columns(op: LogicalOp) -> Optional[set]:
    if op.kind == "SCAN":
        return set(op.attrs.get("columns", ())) or None
    if op.kind == "PROJECT":
        return set(op.attrs["cols"])
    if op.kind in ("SELECT",):
        return _visible_columns(op.children[0])
    return None


# ---------------------------------------------------------------------------
# Logical -> physical translation with R2-R5 inline
# ---------------------------------------------------------------------------

def _to_physical(op: LogicalOp, cat: Catalog, cfg: RewriteConfig) -> PhysicalOp:
    k = op.kind

    if k == "SCAN":
        ds = op.attrs["dataset"]
        pk = cat.primary_keys.get(ds, ())
        return PhysicalOp("DATASET_SCAN", (), (), dict(op.attrs),
                          hash_partitioned(*pk, local_order=pk))

    if k == "SELECT":
        child_l = op.children[0]
        hints = op.attrs.get("hints", ())
        # R2: index access path — paper: ALWAYS take the index when available,
        # unless hinted off ("skip-index" is AsterixDB's real hint name).
        if (cfg.use_indexes and "skip-index" not in hints
                and child_l.kind == "SCAN"):
            ds = child_l.attrs["dataset"]
            pk = cat.primary_keys.get(ds, ())
            # fuzzy (ngram rule): whole-field similarity predicates lower
            # to the Figure-6 skeleton with a T-occurrence filter between
            # the gram search and the PK sort:
            #   NGRAM_INDEX_SEARCH -> T_OCCURRENCE -> SORT_PK ->
            #   PRIMARY_INDEX_LOOKUP -> POST_VALIDATE_SELECT (verify)
            fz = op.attrs.get("fuzzy")
            if fz is not None:
                ix = cat.index_on(ds, fz[0])
                if ix is not None and ix.kind == "ngram":
                    sec = PhysicalOp(
                        "NGRAM_INDEX_SEARCH", (), (),
                        {"index": ix.name, "dataset": ds, "field": fz[0],
                         "spec": fz, "gram_length": ix.gram_length},
                        hash_partitioned(*pk))
                    tocc = PhysicalOp(
                        "T_OCCURRENCE", (sec,), (ONE_TO_ONE,),
                        {"spec": fz, "gram_length": ix.gram_length},
                        sec.delivered)
                    sort = PhysicalOp("SORT_PK", (tocc,), (ONE_TO_ONE,),
                                      {"keys": pk},
                                      hash_partitioned(*pk, local_order=pk))
                    lookup = PhysicalOp(
                        "PRIMARY_INDEX_LOOKUP", (sort,), (ONE_TO_ONE,),
                        {"dataset": ds},
                        hash_partitioned(*pk, local_order=pk))
                    return PhysicalOp(
                        "POST_VALIDATE_SELECT", (lookup,), (ONE_TO_ONE,),
                        {"pred": op.attrs["pred"],
                         "fields": op.attrs["fields"],
                         "ranges": op.attrs.get("ranges", {}),
                         "ranges_exact": bool(op.attrs.get("ranges_exact",
                                                           False)),
                         "fuzzy": fz, "gram_length": ix.gram_length},
                        lookup.delivered)
            # rtree (paper Q5) and keyword (paper Q6) access paths share the
            # Figure-6 skeleton: index search -> SORT_PK -> primary lookup
            # -> post-validate.
            for attr_name, op_kind in (("spatial", "SPATIAL_INDEX_SEARCH"),
                                       ("keyword", "KEYWORD_INDEX_SEARCH")):
                spec = op.attrs.get(attr_name)
                if spec is None:
                    continue
                ix = cat.index_on(ds, spec[0])
                if ix is None or ix.kind != {"spatial": "rtree",
                                             "keyword": "keyword"}[attr_name]:
                    continue
                sec = PhysicalOp(op_kind, (), (),
                                 {"index": ix.name, "dataset": ds,
                                  "field": spec[0], "args": spec[1:]},
                                 hash_partitioned(*pk))
                sort = PhysicalOp("SORT_PK", (sec,), (ONE_TO_ONE,),
                                  {"keys": pk},
                                  hash_partitioned(*pk, local_order=pk))
                lookup = PhysicalOp(
                    "PRIMARY_INDEX_LOOKUP", (sort,), (ONE_TO_ONE,),
                    {"dataset": ds},
                    hash_partitioned(*pk, local_order=pk))
                return PhysicalOp(
                    "POST_VALIDATE_SELECT", (lookup,), (ONE_TO_ONE,),
                    {"pred": op.attrs["pred"], "fields": op.attrs["fields"],
                     "ranges": op.attrs.get("ranges", {}),
                     "ranges_exact": bool(op.attrs.get("ranges_exact",
                                                       False))},
                    lookup.delivered)
        if (cfg.use_indexes and "skip-index" not in hints
                and child_l.kind == "SCAN" and op.attrs.get("ranges")):
            ds = child_l.attrs["dataset"]
            for fld, (lo, hi) in op.attrs["ranges"].items():
                ix = cat.index_on(ds, fld)
                if ix is not None and ix.kind == "btree":
                    pk = cat.primary_keys.get(ds, ())
                    sec = PhysicalOp(
                        "SECONDARY_INDEX_SEARCH", (), (),
                        {"index": ix.name, "dataset": ds, "field": fld,
                         "lo": lo, "hi": hi},
                        hash_partitioned(*pk))
                    sort = PhysicalOp("SORT_PK", (sec,), (ONE_TO_ONE,),
                                      {"keys": pk},
                                      hash_partitioned(*pk, local_order=pk))
                    lookup = PhysicalOp(
                        "PRIMARY_INDEX_LOOKUP", (sort,), (ONE_TO_ONE,),
                        {"dataset": ds},
                        hash_partitioned(*pk, local_order=pk))
                    # §4.4: secondary lookups are post-validated against the
                    # primary record under proper locks (Figure 6's extra
                    # select) — without this, concurrently-merged LSM
                    # components could surface stale entries.
                    return PhysicalOp(
                        "POST_VALIDATE_SELECT", (lookup,), (ONE_TO_ONE,),
                        {"pred": op.attrs["pred"], "fields": op.attrs["fields"],
                         "ranges": op.attrs["ranges"],
                         "ranges_exact": bool(op.attrs.get("ranges_exact",
                                                           False))},
                        lookup.delivered)
        child = _to_physical(child_l, cat, cfg)
        return PhysicalOp("STREAM_SELECT", (child,), (ONE_TO_ONE,),
                          dict(op.attrs), child.delivered)

    if k == "PROJECT":
        child = _to_physical(op.children[0], cat, cfg)
        return PhysicalOp("STREAM_PROJECT", (child,), (ONE_TO_ONE,),
                          dict(op.attrs), child.delivered)

    if k == "JOIN":
        left = _to_physical(op.children[0], cat, cfg)
        right = _to_physical(op.children[1], cat, cfg)
        lk, rk = op.attrs["lkeys"], op.attrs["rkeys"]
        hints = op.attrs.get("hints", ())
        if "indexnl" in hints and op.children[1].kind == "SCAN":
            # paper Query 14: index nested-loop join hint — probe the right
            # side's primary index per left row (right side must be a base
            # dataset scan; otherwise fall through to the hash join).
            rds = op.children[1].attrs["dataset"]
            if tuple(rk) == tuple(cat.primary_keys.get(rds, ())):
                return PhysicalOp(
                    "INDEX_NL_JOIN",
                    (left,),
                    (_exchange(left.delivered, hash_partitioned(*lk)),),
                    {**op.attrs, "right_dataset": rds},
                    hash_partitioned(*lk))
        # R3 + R6: hybrid hash join; repartition each side iff needed
        lconn = _exchange(left.delivered, hash_partitioned(*lk))
        rconn = _exchange(right.delivered, hash_partitioned(*rk))
        return PhysicalOp("HYBRID_HASH_JOIN", (left, right), (lconn, rconn),
                          dict(op.attrs), hash_partitioned(*lk))

    if k == "AGG":
        child = _to_physical(op.children[0], cat, cfg)
        if not cfg.split_aggregation:
            return PhysicalOp("GLOBAL_AGG", (child,), (ReplicateToOne(),),
                              dict(op.attrs), SINGLETON)
        # R4 (Figure 6): local agg on each partition, replicate to the one
        # global instance, combine.
        local = PhysicalOp("LOCAL_AGG", (child,), (ONE_TO_ONE,),
                           dict(op.attrs), child.delivered)
        return PhysicalOp("GLOBAL_AGG", (local,), (ReplicateToOne(),),
                          dict(op.attrs), SINGLETON)

    if k == "GROUPBY":
        child = _to_physical(op.children[0], cat, cfg)
        keys = op.attrs["keys"]
        if not cfg.split_aggregation:
            conn = _exchange(child.delivered, hash_partitioned(*keys))
            return PhysicalOp("HASH_GROUP", (child,), (conn,), dict(op.attrs),
                              hash_partitioned(*keys))
        local = PhysicalOp("LOCAL_PREAGG", (child,), (ONE_TO_ONE,),
                           dict(op.attrs), child.delivered)
        conn = _exchange(local.delivered, hash_partitioned(*keys))
        return PhysicalOp("GLOBAL_GROUP", (local,), (conn,), dict(op.attrs),
                          hash_partitioned(*keys))

    if k == "ORDERBY":
        child = _to_physical(op.children[0], cat, cfg)
        local = PhysicalOp("LOCAL_SORT", (child,), (ONE_TO_ONE,),
                           dict(op.attrs),
                           Partitioning(child.delivered.kind,
                                        child.delivered.keys,
                                        tuple(op.attrs["keys"])))
        return PhysicalOp("SORT_MERGE_GATHER", (local,), (ReplicateToOne(),),
                          dict(op.attrs), SINGLETON)

    if k == "LIMIT":
        child_l = op.children[0]
        # R5: fuse LIMIT into the sort as a per-partition TopK (beyond-paper)
        if cfg.push_limit_into_sort and child_l.kind == "ORDERBY":
            inner = _to_physical(child_l.children[0], cat, cfg)
            attrs = {**child_l.attrs, "n": op.attrs["n"]}
            topk = PhysicalOp("LOCAL_TOPK", (inner,), (ONE_TO_ONE,), attrs,
                              inner.delivered)
            return PhysicalOp("TOPK_MERGE", (topk,), (ReplicateToOne(),),
                              attrs, SINGLETON)
        child = _to_physical(child_l, cat, cfg)
        return PhysicalOp("STREAM_LIMIT", (child,), (ONE_TO_ONE,),
                          dict(op.attrs), child.delivered)

    raise ValueError(f"unknown logical operator {k}")


def _exchange(delivered: Partitioning, required: Partitioning) -> Connector:
    """R6: the minimal connector turning `delivered` into `required`."""
    if delivered.satisfies(required):
        return ONE_TO_ONE
    if required.kind == "hash":
        if required.local_order:
            return MToNHashPartitionMerge(required.keys, required.local_order)
        return MToNHashPartition(*required.keys)
    if required.kind == "broadcast":
        return MToNReplicate()
    if required.kind == "singleton":
        return ReplicateToOne()
    return ONE_TO_ONE


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def optimize(plan: LogicalOp, catalog: Catalog,
             config: RewriteConfig = RewriteConfig()) -> PhysicalOp:
    plan = _r1_select_pushdown(plan)
    return _to_physical(plan, catalog, config)


def explain(plan: LogicalOp, catalog: Catalog,
            config: RewriteConfig = RewriteConfig()) -> str:
    phys = optimize(plan, catalog, config)
    return phys.pretty()
