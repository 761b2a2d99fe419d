"""Generic LSM index framework (paper §4.3–4.4), columnar-native.

AsterixDB "wholly embraced" LSM trees: every index is a mutable *in-memory
component* plus immutable *disk components*; flush on memory threshold, merge
under a policy; recovery uses LSM-index-level **logical logging** (no-steal/
no-force WAL, one log record per index update) plus **component shadowing**
(a new component becomes real only when its *validity bit* is set — invalid
components are deleted at recovery).

This module is the host-side framework: it "LSM-ifies" a sorted-array index
(our B+-tree stand-in: binary search over sorted keys).  It backs the
partitioned storage engine (storage/) and the same component/validity/merge
calculus is reused device-side by the LSM-tiered KV cache (kvcache/) and by
the checkpoint manager (checkpoint/).

Storage is **columnar-first** (cf. the columnar-LSM paper in PAPERS.md):
``flush()`` shreds the memtable of a record (dict-valued) index straight
into a sorted-by-key ``columnar.batch.ColumnBatch`` + tombstone bitmap,
which *is* the component's primary on-disk representation; ``merge()`` is
a column-wise k-way merge whose take-indices come from the vectorized
``kernels.columnar_ops.sorted_merge_take`` kernel (newest-wins dedup +
tombstone collapse), so no row dict is ever materialized on the merge
path; ``recover()`` keeps surviving columnar components as-is and replays
the WAL tail into the memtable, which re-shreds at its next flush.  Row
dicts are a *derived, lazy* view (``Component.rows``) built only for
legacy row-at-a-time callers.  Indexes whose values are not records
keep the classic row-array storage (``columnar=False`` forces it, e.g.
for benchmarking the old row path).  Secondary index structures are not
separate LSM trees at all: components carry per-field columnar CSR
postings (``gram_postings`` for ngram, ``sec_postings`` for
btree/rtree/keyword) as derived data built beside the batch.

Transaction model (paper §2.4/§4.4 — "transaction support akin to that
of a NoSQL store", serving reads while feeds ingest):

  * **Writes are serialized per index** — every mutation (``insert`` /
    ``delete`` / ``insert_batch`` / ``flush`` / ``merge``) runs under the
    index's reentrant ``_lock``, so the WAL append, the memtable update,
    and any flush/merge the update triggers are one atomic step with
    respect to other writers and to snapshot pins.  Different partitions
    of a dataset hold different LSMIndex objects, so partitioned writes
    stay concurrent across partitions.
  * **Reads get snapshot isolation via component-set pinning** —
    ``pin()`` returns a refcounted :class:`LSMView`: a frozen
    (memtable-copy, valid-component-tuple) pair stamped with the index's
    monotone ``version``.  Components are immutable and the view's
    memtable is a private copy, so a pinned reader sees one consistent
    LSM state end to end with zero further coordination (no lock on the
    read path).
  * **Flush/merge install new component lists copy-on-write** — the
    ``components`` list is never mutated in place; a new list is built
    and rebound in one assignment, so any concurrently-grabbed reference
    (a pinned view's tuple, an in-flight iteration) stays valid.
  * **Deferred physical retirement** — a merge that replaces components
    cannot drop them while a pinned view still references them: each
    pin takes a per-component refcount, and replaced components with a
    nonzero pincount park in ``_deferred`` until their last ``unpin``
    (then ``Component.retired`` flips and the ``lsm.deferred_retires``
    counter ticks).  ``pinned_versions()`` exposes the live pin set so
    the dataset's scan cache can key (and GC) entries by snapshot
    version.
"""

from __future__ import annotations

import bisect
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs as _obs
from ..columnar.batch import ColumnBatch
from ..columnar.schema import ColumnSchema

__all__ = ["Component", "LSMIndex", "LSMView", "TieredMergePolicy",
           "WALRecord", "TOMBSTONE", "key_array", "recover",
           "component_nbytes"]

# process-wide storage metrics (see obs.__init__ for the name registry);
# handles resolved once so flush/merge pay dict-free increments
_FLUSH_S = _obs.histogram("lsm.flush_seconds")
_MERGE_S = _obs.histogram("lsm.merge_seconds")
_POSTINGS_S = _obs.histogram("lsm.postings_build_seconds")
_COMP_ROWS = _obs.histogram("lsm.component_rows")
_COMP_BYTES = _obs.histogram("lsm.component_bytes")
_FLUSHES = _obs.counter("lsm.flushes")
_MERGES = _obs.counter("lsm.merges")
_ROWS_INGESTED = _obs.counter("lsm.rows_ingested")
_ROWS_FLUSHED = _obs.counter("lsm.rows_flushed")
_ROWS_MERGED = _obs.counter("lsm.rows_merged")
_BYTES_FLUSHED = _obs.counter("lsm.bytes_flushed")
_BYTES_MERGED = _obs.counter("lsm.bytes_merged")
_COMPONENTS = _obs.gauge("lsm.components")
_PINS = _obs.counter("lsm.pins")
_DEFERRED = _obs.counter("lsm.deferred_retires")
_PINNED_G = _obs.gauge("lsm.pinned_snapshots")


def _pool_release(comp: "Component") -> None:
    """Device-pool eviction hook: a component's device buffers are freed
    at the exact moment its ``retired`` flag flips — immediately at merge
    when unpinned, or deferred until the last snapshot pin drops (lazy
    import: the storage layer works without the kernel stack loaded)."""
    from ..kernels.device_pool import pool
    pool.release_component(comp)


def _arr_nbytes(a: Optional[np.ndarray]) -> int:
    if a is None:
        return 0
    if a.dtype == object:
        return 8 * int(a.shape[0])      # pointer-width estimate
    return int(a.nbytes)


def component_nbytes(comp: "Component") -> int:
    """Estimated storage footprint of one component: column data arrays +
    validity bitmaps + string dictionaries + key array + tombstone
    bitmap (row-mode components estimate pointer width per row)."""
    total = _arr_nbytes(comp.keys) + _arr_nbytes(comp.tomb)
    if comp.batch is not None:
        for col in comp.batch.columns.values():
            total += _arr_nbytes(col.data) + _arr_nbytes(col.valid)
            if col.values:
                total += sum(len(v) if isinstance(v, str) else 8
                             for v in col.values)
    elif comp._rows is not None:
        total += 8 * len(comp._rows)
    return total


class _Tombstone:
    def __repr__(self) -> str:
        return "<TOMBSTONE>"


TOMBSTONE = _Tombstone()

_component_ids = itertools.count()


def _obj_array(items: Sequence[Any]) -> np.ndarray:
    """1-D object array even for uniform tuples (np.asarray would build a
    2-D array out of a list of equal-length tuples, breaking searchsorted)."""
    arr = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        arr[i] = x
    return arr


def key_array(ks: Sequence[Any]) -> np.ndarray:
    """Sorted-run key-array conversion, shared by flush sorting and the
    dataset's live-row selection: a numeric ndarray when the key domain
    converts losslessly, else a 1-D object array of python scalars.
    Numpy scalar inputs normalize to python first — their cross-dtype
    comparisons promote lossily — and the tolist round-trip rejects lossy
    unification (e.g. an int beyond 2**53 coerced to float64 by a mixed
    int/float domain)."""
    ks = [k.item() if isinstance(k, np.generic) else k for k in ks]
    try:
        arr = np.asarray(ks)
        if arr.dtype == object or arr.dtype.kind not in "biuf" \
                or arr.tolist() != ks:
            raise TypeError("non-numeric keys")
        return arr
    except (TypeError, ValueError, OverflowError):
        return _obj_array(ks)


def _sorted_kv(mem: Dict[Any, Any]) -> Tuple[np.ndarray, List[Any]]:
    """(sorted key array, aligned values).  Numeric key domains sort via
    numpy argsort and stay numeric arrays (so downstream kernels — merge
    take-indices, candidate bitmaps — run vectorized); anything else
    falls back to python sort over an object array."""
    arr = key_array(list(mem))
    vals = list(mem.values())           # aligned with list(mem)
    if arr.dtype != object:
        order = np.argsort(arr, kind="stable")
        return arr[order], [vals[j] for j in order.tolist()]
    order = sorted(range(arr.shape[0]), key=arr.__getitem__)
    idx = np.asarray(order, dtype=np.int64) if order \
        else np.zeros(0, dtype=np.int64)
    return arr[idx], [vals[j] for j in order]


@dataclass
class Component:
    """An immutable sorted run.  ``valid`` is the paper's validity bit: set
    atomically as the final action of the flush/merge that created it.

    Record components store a ``batch`` (ColumnBatch, shredded at flush/
    merge) plus a ``tomb`` bitmap as primary data; the row-dict view is
    derived lazily.  Row-mode components (non-record values, or a forced
    row path) store the object array directly and can derive a batch view
    on demand (``as_batch``).

    ``gram_postings`` holds the fuzzy subsystem's per-field ngram(k) CSR
    postings (fuzzy/ngram.GramPostings), built at flush/merge right next
    to the batch — from the batch's string dictionary, never from row
    dicts — for every field the owning index registers in
    ``ngram_fields``.  ``sec_postings`` is the same calculus generalized
    to the btree/rtree/keyword secondary kinds
    (columnar/postings.FieldPostings): per-field CSR candidate structures
    keyed by their index spec, derived from the batch exactly like ngram
    postings and adopted as-is by recovery."""

    keys: np.ndarray                      # sorted; numeric or object dtype
    batch: Optional[ColumnBatch] = None   # columnar primary data
    tomb: Optional[np.ndarray] = None     # bool bitmap: entry is a delete
    valid: bool = False
    retired: bool = False                 # physically retired (replaced by a
    #                                       merge and no longer pinned)
    comp_id: int = field(default_factory=lambda: next(_component_ids))
    gram_postings: Dict[str, Any] = field(default_factory=dict, repr=False)
    sec_postings: Dict[str, Any] = field(default_factory=dict, repr=False)
    _rows: Optional[np.ndarray] = field(default=None, repr=False)

    @classmethod
    def build(cls, keys: np.ndarray, vals: Sequence[Any],
              schema: Optional[Any] = None,
              columnar: Optional[bool] = None,
              ngram_fields: Optional[Dict[str, int]] = None,
              sec_fields: Optional[Dict[str, Tuple[str, Any]]] = None
              ) -> "Component":
        """Shred sorted (key, value) pairs into a component.  Values that
        are all records (dicts) or tombstones shred columnar (unless
        ``columnar=False``); anything else keeps row storage.
        ``ngram_fields`` (field -> gram length) and ``sec_fields``
        (field -> (kind, param) secondary spec) name fields that get
        postings built alongside the batch."""
        tomb = np.fromiter((v is TOMBSTONE for v in vals), dtype=bool,
                           count=len(vals))
        shred = columnar is not False and all(
            v is TOMBSTONE or isinstance(v, dict) for v in vals)
        if not shred:
            c = cls(keys=keys, tomb=tomb)
            c._rows = _obj_array(vals)
            c._build_postings(ngram_fields, sec_fields)
            return c
        rows = [{} if t else v for t, v in zip(tomb.tolist(), vals)]
        sch = schema() if callable(schema) else schema
        if sch is not None:
            extra: Optional[ColumnSchema] = None
            for r in rows:          # never drop fields the schema missed
                for k, v in r.items():
                    if k not in sch:
                        extra = extra or ColumnSchema()
                        extra.observe_value(k, v)
            if extra is not None:
                sch = sch.union(extra)
        c = cls(keys=keys, batch=ColumnBatch.from_rows(rows, sch),
                tomb=tomb)
        c._build_postings(ngram_fields, sec_fields)
        return c

    def _build_ngrams(self, ngram_fields: Optional[Dict[str, int]]) -> None:
        for fld, k in (ngram_fields or {}).items():
            self.ensure_gram_postings(fld, k)

    def _build_postings(self, ngram_fields: Optional[Dict[str, int]],
                        sec_fields: Optional[Dict[str, Tuple[str, Any]]]
                        ) -> None:
        self._build_ngrams(ngram_fields)
        for fld, spec in (sec_fields or {}).items():
            self.ensure_sec_postings(fld, spec)

    def ensure_sec_postings(self, fld: str, spec: Tuple[str, Any]) -> Any:
        """The field's secondary (btree/rtree/keyword) CSR postings, built
        once per component and per spec (a changed spec — e.g. a new
        rtree cell size — rebuilds).  Columnar components shred from the
        batch column; row-mode components fall back to the value list."""
        p = self.sec_postings.get(fld)
        if p is not None and p.spec == spec:
            return p
        from ..columnar.postings import FieldPostings
        t0 = time.perf_counter()
        with _obs.span("lsm.postings_build", field=fld):
            if self.batch is not None:
                p = FieldPostings.from_batch(self.batch, fld, spec,
                                             self.size)
            else:
                vals = [r.get(fld) if isinstance(r, dict) else None
                        for r in (self._rows
                                  if self._rows is not None else ())]
                p = FieldPostings.from_values(vals, spec)
        _POSTINGS_S.observe(time.perf_counter() - t0)
        self.sec_postings[fld] = p
        return p

    def ensure_gram_postings(self, fld: str, k: int) -> Any:
        """The field's ngram(k) postings, built once per component (it is
        immutable).  Columnar components shred from the batch column
        (gram hashing per dictionary value); row-mode components fall
        back to the value list."""
        p = self.gram_postings.get(fld)
        if p is not None and p.k == k:
            return p
        from ..fuzzy.ngram import GramPostings
        t0 = time.perf_counter()
        with _obs.span("lsm.postings_build", field=fld):
            if self.batch is not None:
                p = GramPostings.from_batch(self.batch, fld, k, self.size)
            else:
                vals = [r.get(fld) if isinstance(r, dict) else None
                        for r in (self._rows
                                  if self._rows is not None else ())]
                p = GramPostings.from_values(vals, k)
        _POSTINGS_S.observe(time.perf_counter() - t0)
        self.gram_postings[fld] = p
        return p

    @property
    def size(self) -> int:
        return int(self.keys.shape[0])

    @property
    def key_range(self) -> Tuple[Any, Any]:
        return (self.keys[0], self.keys[-1]) if self.size else (None, None)

    @property
    def is_columnar(self) -> bool:
        return self.batch is not None

    @property
    def rows(self) -> np.ndarray:
        """Derived row-dict view (lazy, cached): TOMBSTONE sentinels where
        ``tomb`` is set, reassembled records elsewhere.  Only legacy
        row-at-a-time callers force this; flush/merge/scan never do."""
        if self._rows is None:
            decoded = self.batch.to_rows()
            out = np.empty(len(decoded), dtype=object)
            tomb = self.tomb
            for i, r in enumerate(decoded):
                out[i] = TOMBSTONE if tomb[i] else r
            self._rows = out
        return self._rows

    def as_batch(self, schema: Optional[Any] = None) -> ColumnBatch:
        """Columnar view: primary storage when shredded at flush/merge;
        shredded once (and cached) for row-mode record components."""
        if self.batch is None:
            sch = schema() if callable(schema) else schema
            self.batch = ColumnBatch.from_rows(
                [r if isinstance(r, dict) else {} for r in self._rows], sch)
        return self.batch

    def row_at(self, i: int) -> Any:
        """Value at position ``i`` without forcing the full row view."""
        if self._rows is not None:
            return self._rows[i]
        if self.tomb[i]:
            return TOMBSTONE
        return self.batch.row_at(i)

    def lookup(self, key: Any) -> Optional[Any]:
        # bisect (not np.searchsorted): tuple keys must stay scalar probes
        i = bisect.bisect_left(self.keys, key)
        if i < self.size and self.keys[i] == key:
            return self.row_at(i)
        return None

    def range(self, lo: Any, hi: Any) -> Tuple[np.ndarray, np.ndarray]:
        i = bisect.bisect_left(self.keys, lo)
        j = bisect.bisect_right(self.keys, hi)
        return self.keys[i:j], self.rows[i:j]


@dataclass(frozen=True)
class WALRecord:
    """One *logical* log record per index update (paper §4.4)."""

    lsn: int
    op: str          # "insert" | "delete"
    key: Any
    row: Any = None


@dataclass(frozen=True)
class TieredMergePolicy:
    """Merge when >= ``k`` components sit within ``ratio`` of each other in
    size (a standard tiered/size-ratio policy; AsterixDB ships constant +
    prefix policies — tiered subsumes the behavior we benchmark)."""

    k: int = 4
    ratio: float = 1.5

    def pick(self, comps: Sequence[Component]) -> Optional[List[int]]:
        if len(comps) < self.k:
            return None
        # components ordered newest->oldest; scan windows of k
        for start in range(0, len(comps) - self.k + 1):
            window = comps[start:start + self.k]
            sizes = [max(c.size, 1) for c in window]
            if max(sizes) <= self.ratio * min(sizes):
                return list(range(start, start + self.k))
        if len(comps) >= 2 * self.k:   # backstop: merge everything old
            return list(range(len(comps) - self.k, len(comps)))
        return None


class LSMView:
    """A point-in-time (memtable, component-set) view of an LSMIndex.

    Two flavours share one read surface:

      * ``LSMIndex.current_view()`` — *unfrozen*: references the live
        memtable (single-threaded read paths; concurrent readers must
        pin instead).
      * ``LSMIndex.pin()`` — *frozen*: the memtable is a private copy,
        the component tuple is refcount-pinned, and ``release()`` (or
        ``LSMIndex.unpin``) must be called exactly once to let replaced
        components physically retire.

    ``version`` is the owning index's monotone mutation counter at view
    time — the snapshot-isolation key the dataset scan cache uses.
    """

    __slots__ = ("version", "memtable", "components", "frozen",
                 "_owner", "_released")

    def __init__(self, version: int, memtable: Dict[Any, Any],
                 components: Tuple[Component, ...], frozen: bool,
                 owner: Optional["LSMIndex"] = None):
        self.version = version
        self.memtable = memtable
        self.components = components      # valid components, newest first
        self.frozen = frozen
        self._owner = owner
        self._released = False

    def release(self) -> None:
        """Drop this view's component pins (frozen views only; idempotent
        no-op for unfrozen ones)."""
        if self.frozen and not self._released and self._owner is not None:
            self._owner.unpin(self)

    def __enter__(self) -> "LSMView":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- read surface (never takes the index lock) --------------------------
    def lookup(self, key: Any) -> Optional[Any]:
        if key in self.memtable:
            r = self.memtable[key]
            return None if r is TOMBSTONE else r
        for c in self.components:
            r = c.lookup(key)
            if r is not None:
                return None if r is TOMBSTONE else r
        return None

    def items(self) -> Iterator[Tuple[Any, Any]]:
        """Live (key, row) pairs, newest-wins, sorted by key."""
        seen: Dict[Any, Any] = {}
        for c in reversed(self.components):
            for k, r in zip(c.keys, c.rows):
                seen[k] = r
        seen.update(self.memtable)
        for k in sorted(seen):
            if seen[k] is not TOMBSTONE:
                yield k, seen[k]


class LSMIndex:
    """LSM-ified ordered index: dict memtable + sorted-run components.

    ``schema`` (a ColumnSchema or a zero-arg callable returning one, e.g.
    ``PartitionedDataset.columnar_schema``) steers flush-time shredding;
    ``ngram_fields`` (a dict field -> gram length, or a zero-arg callable
    returning one) names fields whose flush/merge output carries ngram
    postings; ``sec_fields`` (a dict field -> (kind, param) secondary
    spec, or a zero-arg callable) does the same for btree/rtree/keyword
    CSR postings; ``columnar=False`` forces classic row-array components
    (the benchmarked legacy path)."""

    def __init__(self, flush_threshold: int = 1024,
                 merge_policy: Optional[TieredMergePolicy] = None,
                 wal: Optional[List[WALRecord]] = None,
                 schema: Optional[Any] = None,
                 columnar: Optional[bool] = None,
                 ngram_fields: Optional[Any] = None,
                 sec_fields: Optional[Any] = None):
        self.flush_threshold = int(flush_threshold)
        self.merge_policy = merge_policy or TieredMergePolicy()
        self.memtable: Dict[Any, Any] = {}
        self.components: List[Component] = []   # newest first
        self.wal: List[WALRecord] = wal if wal is not None else []
        self._lsn = itertools.count(len(self.wal))
        self.schema = schema
        self.columnar = columnar
        self.ngram_fields = ngram_fields
        self.sec_fields = sec_fields
        self.stats = {"flushes": 0, "merges": 0, "inserts": 0, "deletes": 0,
                      "merged_rows": 0, "flushed_rows": 0,
                      "flushed_bytes": 0, "merged_bytes": 0,
                      "pins": 0, "deferred_retires": 0}
        self._ingest_counted = 0    # inserts+deletes already counted into
        #                             the process-wide lsm.rows_ingested
        # -- concurrency: per-index write serialization + snapshot pins ----
        self._lock = threading.RLock()   # WAL + memtable + flush/merge path
        self._version = 0                # monotone, bumped on any mutation
        self._comp_pins: Dict[int, int] = {}       # comp_id -> pin count
        self._deferred: Dict[int, Component] = {}  # replaced but still pinned
        self._pin_versions: Dict[int, int] = {}    # version -> live pin count

    def write_amplification(self) -> float:
        """(rows flushed + rows re-written by merges) / rows ingested.
        1.0 means every ingested row was written once and never
        rewritten; tiered merging pushes it up with every rewrite.  0.0
        until the first flush."""
        ingested = self.stats["inserts"] + self.stats["deletes"]
        if not ingested:
            return 0.0
        return (self.stats["flushed_rows"]
                + self.stats["merged_rows"]) / ingested

    # -- snapshot pinning (read-side transaction surface) -------------------
    @property
    def version(self) -> int:
        """Monotone mutation counter: bumps on every insert/delete batch,
        flush, and merge.  Equal versions imply identical visible state,
        so snapshot readers and the dataset scan cache key on it."""
        return self._version

    def current_view(self) -> LSMView:
        """Unfrozen point-in-time view sharing the live memtable (the
        single-threaded read path; concurrent readers must ``pin()``)."""
        return LSMView(self._version, self.memtable,
                       tuple(c for c in self.components if c.valid),
                       frozen=False, owner=self)

    def pin(self) -> LSMView:
        """Refcounted snapshot handle: a frozen (memtable-copy,
        component-tuple) pair.  Components it references cannot be
        physically retired until the matching ``unpin``/``release``."""
        with self._lock:
            comps = tuple(c for c in self.components if c.valid)
            for c in comps:
                self._comp_pins[c.comp_id] = \
                    self._comp_pins.get(c.comp_id, 0) + 1
            self._pin_versions[self._version] = \
                self._pin_versions.get(self._version, 0) + 1
            self.stats["pins"] += 1
            view = LSMView(self._version, dict(self.memtable), comps,
                           frozen=True, owner=self)
        _PINS.inc()
        _PINNED_G.inc()
        return view

    def unpin(self, view: LSMView) -> None:
        """Release one pinned view: drop its component refcounts and
        physically retire any replaced component whose pin count reached
        zero (the deferred half of the merge's copy-on-write swap)."""
        retire: List[Component] = []
        with self._lock:
            if view._released:
                return
            view._released = True
            n = self._pin_versions.get(view.version, 0) - 1
            if n > 0:
                self._pin_versions[view.version] = n
            else:
                self._pin_versions.pop(view.version, None)
            for c in view.components:
                left = self._comp_pins.get(c.comp_id, 0) - 1
                if left > 0:
                    self._comp_pins[c.comp_id] = left
                else:
                    self._comp_pins.pop(c.comp_id, None)
                    dead = self._deferred.pop(c.comp_id, None)
                    if dead is not None:
                        retire.append(dead)
            for dead in retire:
                dead.retired = True
                self.stats["deferred_retires"] += 1
        for dead in retire:
            # deferred half of the device-pool eviction discipline: the
            # buffers outlived the merge exactly as long as the pins did
            _pool_release(dead)
        if retire:
            _DEFERRED.inc(len(retire))
        _PINNED_G.dec()

    def pinned_versions(self) -> Tuple[int, ...]:
        """Versions with at least one live pin (scan-cache GC keeps
        entries for exactly these plus the current version)."""
        return tuple(self._pin_versions)

    def _retire_replaced(self, replaced: Sequence[Component]) -> None:
        """Called under ``_lock`` by merge after the copy-on-write swap:
        unpinned components retire immediately, pinned ones defer."""
        for c in replaced:
            if self._comp_pins.get(c.comp_id, 0) > 0:
                self._deferred[c.comp_id] = c
            else:
                c.retired = True
                self.stats["deferred_retires"] += 1
                _DEFERRED.inc()
                _pool_release(c)       # merged away, unpinned: free now

    # -- update path (record-level "transactions": WAL then apply) ---------
    def insert(self, key: Any, row: Any) -> None:
        with self._lock:
            self.wal.append(WALRecord(next(self._lsn), "insert", key, row))
            self.memtable[key] = row
            self.stats["inserts"] += 1
            self._version += 1
            if len(self.memtable) >= self.flush_threshold:
                self.flush()

    def delete(self, key: Any) -> None:
        with self._lock:
            self.wal.append(WALRecord(next(self._lsn), "delete", key))
            self.memtable[key] = TOMBSTONE
            self.stats["deletes"] += 1
            self._version += 1
            if len(self.memtable) >= self.flush_threshold:
                self.flush()

    def insert_batch(self, keys: Sequence[Any], rows: Sequence[Any]) -> None:
        """Paper Table 4: batching amortizes per-statement overhead — one
        WAL/memtable pass per chunk and one flush-threshold check per
        chunk instead of per record (flushes still fire at the same
        thresholds, so component sizes match the per-record path)."""
        with self._lock:
            mem, wal, lsn = self.memtable, self.wal, self._lsn
            i, n = 0, len(keys)
            while i < n:
                take = max(self.flush_threshold - len(mem), 1)
                for k, r in zip(keys[i:i + take], rows[i:i + take]):
                    wal.append(WALRecord(next(lsn), "insert", k, r))
                    mem[k] = r
                done = min(i + take, n) - i
                self.stats["inserts"] += done
                i += take
                self._version += 1
                if len(mem) >= self.flush_threshold:
                    self.flush()
                    mem = self.memtable     # flush installed a fresh dict

    # -- flush / merge ------------------------------------------------------
    def _ngram(self) -> Dict[str, int]:
        nf = self.ngram_fields
        return nf() if callable(nf) else (nf or {})

    def _sec(self) -> Dict[str, Tuple[str, Any]]:
        sf = self.sec_fields
        return sf() if callable(sf) else (sf or {})

    def flush(self, *, crash_before_validity: bool = False) -> Optional[Component]:
        """Shadow-install the memtable as a new immutable component,
        shredding record values straight into the component's primary
        ColumnBatch (sorted by key) — rows are never re-materialized.
        With ``crash_before_validity`` the validity bit is never set,
        simulating a crash mid-flush: recovery must ignore the component
        (paper §4.4)."""
        with self._lock:
            if not self.memtable:
                return None
            t0 = time.perf_counter()
            with _obs.span("lsm.flush") as sp:
                keys, vals = _sorted_kv(self.memtable)
                comp = Component.build(keys, vals, schema=self.schema,
                                       columnar=self.columnar,
                                       ngram_fields=self._ngram(),
                                       sec_fields=self._sec())
                # copy-on-write shadow install: present but invalid; the
                # list object pinned views / in-flight readers grabbed is
                # never mutated, only rebound
                self.components = [comp] + self.components
                if crash_before_validity:
                    return comp
                comp.valid = True              # atomic install
                self.memtable = {}
                self._version += 1
                self.stats["flushes"] += 1
                nbytes = component_nbytes(comp)
                self.stats["flushed_rows"] += comp.size
                self.stats["flushed_bytes"] += nbytes
                sp.set("rows", comp.size)
                sp.set("bytes", nbytes)
            _FLUSH_S.observe(time.perf_counter() - t0)
            _FLUSHES.inc()
            _ROWS_FLUSHED.inc(comp.size)
            _BYTES_FLUSHED.inc(nbytes)
            _COMP_ROWS.observe(comp.size)
            _COMP_BYTES.observe(nbytes)
            # ingest accounting at flush granularity (never per-row): the
            # delta of this index's insert+delete counters since last flush
            ingested = self.stats["inserts"] + self.stats["deletes"]
            _ROWS_INGESTED.inc(ingested - self._ingest_counted)
            self._ingest_counted = ingested
            _COMPONENTS.set(sum(1 for c in self.components if c.valid))
            self._maybe_merge()
            return comp

    def _maybe_merge(self) -> None:
        while True:
            valid = [c for c in self.components if c.valid]
            pick = self.merge_policy.pick(valid)
            if pick is None:
                return
            self.merge([valid[i] for i in pick])

    def merge(self, comps: Sequence[Component],
              *, crash_before_validity: bool = False) -> Component:
        """Column-wise k-way merge: the ``sorted_merge_take`` kernel
        computes newest-wins take-indices over the per-component sorted
        key arrays once, then every column — merged string dictionaries
        included — is gathered without materializing a single row dict.
        Tombstones survive the merge unless it includes the oldest
        component (then they collapse).  Row-mode inputs (secondary
        indexes, forced row path) merge via the classic dict pass."""
        comps = list(comps)                    # newest -> oldest
        self._lock.acquire()
        try:
            return self._merge_locked(comps, crash_before_validity)
        finally:
            self._lock.release()

    def _merge_locked(self, comps: List[Component],
                      crash_before_validity: bool) -> Component:
        t0 = time.perf_counter()
        with _obs.span("lsm.merge", components=len(comps)) as sp:
            includes_oldest = self.components and comps[-1] is [
                c for c in self.components if c.valid][-1]
            if self.columnar is not False \
                    and all(c.batch is not None for c in comps):
                merged, keys, tomb = ColumnBatch.merge_sorted(
                    [c.batch for c in comps], [c.keys for c in comps],
                    [c.tomb for c in comps],
                    drop_tombstones=bool(includes_oldest))
                out = Component(keys=keys, batch=merged, tomb=tomb)
                # postings (ngram + secondary CSR) ride the merge too
                out._build_postings(self._ngram(), self._sec())
            else:
                seen: Dict[Any, Any] = {}
                for c in reversed(comps):      # oldest first; newer overwrite
                    for k, r in zip(c.keys, c.rows):
                        seen[k] = r
                if includes_oldest:
                    seen = {k: r for k, r in seen.items()
                            if r is not TOMBSTONE}
                keys, vals = _sorted_kv(seen)
                out = Component.build(keys, vals, schema=self.schema,
                                      columnar=self.columnar,
                                      ngram_fields=self._ngram(),
                                      sec_fields=self._sec())
            ids = {c.comp_id for c in comps}
            pos = min(i for i, c in enumerate(self.components)
                      if c.comp_id in ids)
            # copy-on-write shadow install next to the inputs
            shadowed = list(self.components)
            shadowed.insert(pos, out)
            self.components = shadowed
            if crash_before_validity:
                return out
            out.valid = True                   # atomic swap: install + retire
            self.components = [c for c in self.components
                               if c.comp_id not in ids]
            self._version += 1
            # replaced components physically retire now unless a pinned
            # snapshot still references them (then: deferred to unpin)
            self._retire_replaced(comps)
            self.stats["merges"] += 1
            self.stats["merged_rows"] += out.size
            nbytes = component_nbytes(out)
            self.stats["merged_bytes"] += nbytes
            sp.set("rows", out.size)
            sp.set("bytes", nbytes)
        _MERGE_S.observe(time.perf_counter() - t0)
        _MERGES.inc()
        _ROWS_MERGED.inc(out.size)
        _BYTES_MERGED.inc(nbytes)
        _COMP_ROWS.observe(out.size)
        _COMP_BYTES.observe(nbytes)
        _COMPONENTS.set(sum(1 for c in self.components if c.valid))
        return out

    # -- read path ----------------------------------------------------------
    def lookup(self, key: Any) -> Optional[Any]:
        if key in self.memtable:
            r = self.memtable[key]
            return None if r is TOMBSTONE else r
        for c in self.components:
            if not c.valid:
                continue
            r = c.lookup(key)
            if r is not None:
                return None if r is TOMBSTONE else r
        return None

    def range(self, lo: Any, hi: Any) -> List[Tuple[Any, Any]]:
        """Merged range scan across memtable + all valid components."""
        seen = self._range_merged(lo, hi)
        return [(k, seen[k]) for k in sorted(seen) if seen[k] is not TOMBSTONE]

    def range_values(self, lo: Any, hi: Any) -> List[Any]:
        """Live row values in [lo, hi], newest-wins, without sorting by key
        or materializing (key, row) pairs.  This is the candidate read path
        for secondary indexes, whose rows are primary keys: the caller gets
        a flat PK list to sort/intersect columnar-side (vectorized index
        access), never decoded records."""
        seen = self._range_merged(lo, hi)
        return [r for r in seen.values() if r is not TOMBSTONE]

    def _range_merged(self, lo: Any, hi: Any) -> Dict[Any, Any]:
        seen: Dict[Any, Any] = {}
        for c in reversed([c for c in self.components if c.valid]):
            ks, rs = c.range(lo, hi)
            for k, r in zip(ks, rs):
                seen[k] = r
        for k, r in self.memtable.items():
            if lo <= k <= hi:
                seen[k] = r
        return seen

    def __len__(self) -> int:
        return sum(1 for _ in self.items())

    def items(self) -> Iterator[Tuple[Any, Any]]:
        seen: Dict[Any, Any] = {}
        for c in reversed([c for c in self.components if c.valid]):
            for k, r in zip(c.keys, c.rows):
                seen[k] = r
        seen.update(self.memtable)
        for k in sorted(seen):
            if seen[k] is not TOMBSTONE:
                yield k, seen[k]


def recover(components: Sequence[Component], wal: Sequence[WALRecord],
            *, replay_from_lsn: int = 0, flush_threshold: int = 1024,
            schema: Optional[Any] = None,
            columnar: Optional[bool] = None,
            ngram_fields: Optional[Any] = None,
            sec_fields: Optional[Any] = None) -> LSMIndex:
    """Crash recovery (paper §4.4): drop components without the validity bit,
    then replay the committed WAL tail into a fresh memtable.  Surviving
    columnar components are adopted as-is (their batches *are* the data,
    ngram and secondary postings included); the replayed memtable
    re-shreds into the same form at its next flush."""
    idx = LSMIndex(flush_threshold=flush_threshold, schema=schema,
                   columnar=columnar, ngram_fields=ngram_fields,
                   sec_fields=sec_fields)
    idx.components = [c for c in components if c.valid]
    idx.wal = list(wal)
    idx._lsn = itertools.count(len(idx.wal))
    for rec in wal:
        if rec.lsn < replay_from_lsn:
            continue
        if rec.op == "insert":
            idx.memtable[rec.key] = rec.row
        elif rec.op == "delete":
            idx.memtable[rec.key] = TOMBSTONE
    return idx
