"""Algebricks-analogue logical/physical algebra (paper §4.1–4.2).

Jobs are DAGs of Operators and Connectors.  A *logical* plan describes what to
compute; the rewriter (core/rewriter.py) turns it into a *physical* plan where
every edge carries a Connector and every operator declares the partitioning
property it requires/delivers.  Data moves only when required != delivered —
the paper's central optimizer invariant.

Two backends execute the same algebra (Algebricks is "data-model-neutral"):
  * storage/query.py — the faithful mini-BDMS record engine (Tables 3/4)
  * the sharding planner — maps the same property calculus onto PartitionSpecs
    for train/serve steps (runtime/sharding.py)
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Partitioning", "RANDOM", "SINGLETON", "hash_partitioned", "broadcast",
    "Connector", "ONE_TO_ONE", "MToNHashPartition", "MToNReplicate",
    "MToNHashPartitionMerge", "ReplicateToOne",
    "LogicalOp", "PhysicalOp", "scan", "select", "project", "join",
    "group_by", "aggregate", "order_by", "limit",
]


# ---------------------------------------------------------------------------
# Partitioning properties
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Partitioning:
    """Structural property of an operator's output across N partitions."""

    kind: str                       # random | hash | broadcast | singleton
    keys: Tuple[str, ...] = ()
    # local (within-partition) order, used by merging connectors
    local_order: Tuple[str, ...] = ()

    def satisfies(self, required: "Partitioning") -> bool:
        if required.kind == "random":
            return True  # anything is a valid random partitioning
        if required.kind != self.kind:
            return False
        if required.keys and self.keys != required.keys:
            return False
        if required.local_order and self.local_order[:len(required.local_order)] \
                != required.local_order:
            return False
        return True


RANDOM = Partitioning("random")
SINGLETON = Partitioning("singleton")


def hash_partitioned(*keys: str, local_order: Sequence[str] = ()) -> Partitioning:
    return Partitioning("hash", tuple(keys), tuple(local_order))


def broadcast() -> Partitioning:
    return Partitioning("broadcast")


# ---------------------------------------------------------------------------
# Connectors (paper §4.1 lists the Hyracks connector library)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Connector:
    name: str
    keys: Tuple[str, ...] = ()
    sort_keys: Tuple[str, ...] = ()

    def __str__(self) -> str:
        extra = f"({','.join(self.keys)})" if self.keys else ""
        return f"{self.name}{extra}"


ONE_TO_ONE = Connector("OneToOne")


def MToNHashPartition(*keys: str) -> Connector:
    return Connector("MToNHashPartition", tuple(keys))


def MToNReplicate() -> Connector:
    return Connector("MToNReplicate")


def MToNHashPartitionMerge(keys: Sequence[str], sort_keys: Sequence[str]) -> Connector:
    return Connector("MToNHashPartitionMerge", tuple(keys), tuple(sort_keys))


def ReplicateToOne() -> Connector:
    """Fan-in to a singleton global operator (Figure 6's MToNReplicating into
    the one Global Aggregation instance)."""
    return Connector("ReplicateToOne")


# ---------------------------------------------------------------------------
# Logical operators
# ---------------------------------------------------------------------------

_ids = itertools.count()


@dataclass
class LogicalOp:
    kind: str
    children: Tuple["LogicalOp", ...] = ()
    attrs: Dict[str, Any] = field(default_factory=dict)
    op_id: int = field(default_factory=lambda: next(_ids))

    def replace_children(self, children: Sequence["LogicalOp"]) -> "LogicalOp":
        return LogicalOp(self.kind, tuple(children), dict(self.attrs))

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        meta = {k: v for k, v in self.attrs.items() if not callable(v)}
        s = f"{pad}{self.kind} {meta}\n"
        for c in self.children:
            s += c.pretty(indent + 1)
        return s


def scan(dataset: str, **attrs: Any) -> LogicalOp:
    return LogicalOp("SCAN", (), {"dataset": dataset, **attrs})


def select(child: LogicalOp, pred: Callable, *, fields: Sequence[str],
           ranges: Optional[Dict[str, Tuple[Any, Any]]] = None,
           spatial: Optional[Tuple[str, Tuple[float, float], float]] = None,
           keyword: Optional[Tuple[str, str, int]] = None,
           fuzzy: Optional[Tuple[str, str, str, Any]] = None,
           hints: Sequence[str] = (),
           ranges_exact: bool = False) -> LogicalOp:
    """``pred`` evaluates a row -> bool.  ``ranges`` exposes sargable
    [lo, hi] bounds per field (btree rule); ``spatial`` = (field, center,
    radius) exposes a circle predicate (rtree rule, paper Q5); ``keyword`` =
    (field, token, edit_distance) exposes a token predicate (keyword index
    rule, paper Q6); ``fuzzy`` = (field, "ed"|"jaccard", target, param[,
    gram_k]) exposes a whole-field similarity predicate (ngram index
    rule, the paper's fuzzy selects) whose candidates the columnar engine
    generates via T-occurrence and verifies with the batched similarity
    kernels (``fuzzy.fuzzy_predicate(spec)`` builds the matching scalar
    oracle).  ``ranges_exact=True`` asserts that the declared access
    predicates — ``ranges``, plus the fuzzy spec when present — fully
    capture ``pred``, letting the columnar engine skip the row-at-a-time
    residual re-check (and fuse filter+aggregate into one kernel
    pass)."""
    return LogicalOp("SELECT", (child,),
                     {"pred": pred, "fields": tuple(fields),
                      "ranges": dict(ranges or {}), "spatial": spatial,
                      "keyword": keyword, "fuzzy": fuzzy,
                      "hints": tuple(hints),
                      "ranges_exact": bool(ranges_exact)})


def project(child: LogicalOp, cols: Sequence[str]) -> LogicalOp:
    return LogicalOp("PROJECT", (child,), {"cols": tuple(cols)})


def join(left: LogicalOp, right: LogicalOp, lkeys: Sequence[str],
         rkeys: Sequence[str], hints: Sequence[str] = ()) -> LogicalOp:
    return LogicalOp("JOIN", (left, right),
                     {"lkeys": tuple(lkeys), "rkeys": tuple(rkeys),
                      "hints": tuple(hints)})


def group_by(child: LogicalOp, keys: Sequence[str],
             aggs: Dict[str, Tuple[str, str]]) -> LogicalOp:
    """aggs: out_name -> (fn, col) with fn in count|sum|min|max|avg."""
    return LogicalOp("GROUPBY", (child,), {"keys": tuple(keys), "aggs": dict(aggs)})


def aggregate(child: LogicalOp, aggs: Dict[str, Tuple[str, str]]) -> LogicalOp:
    return LogicalOp("AGG", (child,), {"aggs": dict(aggs)})


def order_by(child: LogicalOp, keys: Sequence[str], desc: bool = False) -> LogicalOp:
    return LogicalOp("ORDERBY", (child,), {"keys": tuple(keys), "desc": desc})


def limit(child: LogicalOp, n: int) -> LogicalOp:
    return LogicalOp("LIMIT", (child,), {"n": int(n)})


# ---------------------------------------------------------------------------
# Physical operators
# ---------------------------------------------------------------------------

@dataclass
class PhysicalOp:
    """An operator instance with its delivered partitioning and, per input
    edge, the connector that feeds it."""

    kind: str
    children: Tuple["PhysicalOp", ...] = ()
    connectors: Tuple[Connector, ...] = ()
    attrs: Dict[str, Any] = field(default_factory=dict)
    delivered: Partitioning = RANDOM

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        meta = {k: v for k, v in self.attrs.items() if not callable(v)}
        s = f"{pad}{self.kind} {meta} ~{self.delivered.kind}" \
            f"{list(self.delivered.keys) if self.delivered.keys else ''}\n"
        for conn, c in zip(self.connectors, self.children):
            s += f"{pad} <-[{conn}]-\n"
            s += c.pretty(indent + 1)
        return s

    def all_ops(self) -> List["PhysicalOp"]:
        out = [self]
        for c in self.children:
            out.extend(c.all_ops())
        return out

    def count_connectors(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for op in self.all_ops():
            for conn in op.connectors:
                counts[conn.name] = counts.get(conn.name, 0) + 1
        return counts
