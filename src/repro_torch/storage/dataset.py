"""Hash-partitioned datasets with LSM primary + node-local secondary indexes
(paper §2.2, §4.3-4.4), columnar-native storage.

Faithful structure:
  * a Dataset is hash-partitioned (sharded) on its primary key;
  * each partition's primary index is an LSM "B+-tree" (core/lsm.LSMIndex);
  * secondary indexes are NODE-LOCAL: partition i's secondary structures
    only reference rows stored in partition i, so secondary lookups fan
    out to all partitions and return primary keys (or position bitmaps),
    never rows.  Secondary indexes are not separate LSM trees of
    (key, pk) rows: every primary component carries per-indexed-field
    **columnar CSR postings** (columnar/postings.FieldPostings — sorted
    key dictionary + offsets + row-position arrays; btree values, rtree
    grid-cell codes, keyword tokens), built at flush/merge beside the
    component batch exactly like the fuzzy ngram postings, adopted as-is
    by recovery and backfilled by late ``create_index``.  The mutable
    memtable tail is indexed at query time (cached per storage version),
    and newest-wins/tombstone semantics come from the live-row selection
    — a stale old-version posting is simply never selected — so inserts
    and deletes need no secondary maintenance at all;
  * records are ADM instances (open/closed types, core/adm) — the encoded
    size difference between Schema and KeyOnly types reproduces Table 2;
  * record-level "transactions": every insert/delete WAL-logs before apply;
    recovery = drop invalid components + replay WAL tail (paper §4.4);
  * storage is **columnar-first** (cf. the columnar-LSM paper in
    PAPERS.md): every immutable primary component carries a sorted-by-PK
    ColumnBatch + tombstone bitmap as its *primary* representation,
    shredded once at flush/merge inside core/lsm (the dataset hands the
    LSM layer its ``columnar_schema`` so open fields observed on insert
    shred correctly).  ``scan_partition_batch`` therefore reads component
    batches zero-copy — concat + newest-wins position selection + the
    tombstone bitmaps — decoding nothing; open-type drift is handled by
    merging per-component ColumnSchemas at read time (mixed physical
    kinds widen to ``obj`` on concat).  Row dicts exist only as the LSM
    components' lazy derived view for the row engine;
  * ``insert_batch`` is the feed ingestion path: records are validated
    and grouped per partition, then applied as one WAL+memtable pass per
    partition chunk (skipping per-record old-version lookups when no
    secondary index needs them), so a feed -> memory component -> flush
    pipeline never runs a per-record code path;
  * fuzzy queries ride ``"ngram"`` indexes (fuzzy/): per-component CSR
    gram postings built at flush/merge, T-occurrence candidate bitmaps
    aligned with the columnar scan (``ngram_candidate_mask``), batched
    similarity verification downstream.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core import adm
from ..core.functions import cells_covering_circle
from ..core.lsm import LSMIndex, LSMView, TOMBSTONE, TieredMergePolicy, \
    WALRecord, key_array, recover
from ..columnar.batch import ColumnBatch, promotes_lossless
from ..columnar.postings import FieldPostings, cell_codes_for_query
from ..columnar.schema import ColumnSchema

__all__ = ["PartitionedDataset", "DatasetSnapshot", "hash_partition",
           "hash_partition_array"]


def hash_partition(key: Any, num_partitions: int) -> int:
    """Deterministic hash partitioning (the paper's shard function).  Uses a
    Fibonacci-style integer mix for ints and FNV-1a for strings so partition
    spread does not depend on Python's randomized hash.  Integral floats
    canonicalize to ints first, so a double-pk record stored under 2.0
    routes to the same partition whether a later delete/lookup probes
    with 2 or 2.0 (ADM casts ints into float fields at validation)."""
    if isinstance(key, (float, np.floating)) and float(key).is_integer():
        key = int(key)
    if isinstance(key, (int, np.integer)):
        return int((int(key) * 11400714819323198485) % (2 ** 64)
                   >> 40) % num_partitions
    if isinstance(key, str):
        h = 14695981039346656037
        for b in key.encode():
            h = ((h ^ b) * 1099511628211) % (2 ** 64)
        return h % num_partitions
    return hash(key) % num_partitions


def hash_partition_array(keys: np.ndarray, num_partitions: int) -> np.ndarray:
    """Vectorized integer branch of ``hash_partition``: bit-identical
    placement for integer key arrays (uint64 two's-complement wrap matches
    python's mod-2**64 arithmetic).  The one copy of the mix constant both
    batch routing and the columnar repartition operator share."""
    h = (keys.astype(np.uint64)
         * np.uint64(11400714819323198485)) >> np.uint64(40)
    return (h % np.uint64(num_partitions)).astype(np.int64)


class _BatchGate:
    """Shared/exclusive gate making snapshots *batch*-consistent cuts.

    Writers (``insert`` / ``insert_batch`` / ``delete``) hold the gate
    in shared mode, so concurrent batches on different partitions still
    proceed in parallel; ``pin()`` takes it exclusive for the brief
    moment it pins every partition's LSM view.  Without it a snapshot
    could land *between* the per-partition sub-inserts of one
    ``insert_batch`` and observe half a micro-batch.  Exclusive waiters
    get priority so a steady write load cannot starve snapshot pins."""

    __slots__ = ("_cv", "_shared", "_excl", "_excl_waiting")

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = 0
        self._excl = False
        self._excl_waiting = 0

    def acquire_shared(self) -> None:
        with self._cv:
            while self._excl or self._excl_waiting:
                self._cv.wait()
            self._shared += 1

    def release_shared(self) -> None:
        with self._cv:
            self._shared -= 1
            if self._shared == 0:
                self._cv.notify_all()

    def acquire_exclusive(self) -> None:
        with self._cv:
            self._excl_waiting += 1
            while self._excl or self._shared:
                self._cv.wait()
            self._excl_waiting -= 1
            self._excl = True

    def release_exclusive(self) -> None:
        with self._cv:
            self._excl = False
            self._cv.notify_all()


@dataclass
class _Partition:
    primary: LSMIndex


class PartitionedDataset:
    """An AsterixDB Dataset: typed, partitioned, LSM-indexed."""

    def __init__(self, name: str, dtype: adm.RecordType, primary_key: str,
                 num_partitions: int = 4, flush_threshold: int = 256,
                 merge_policy: Optional[TieredMergePolicy] = None,
                 columnar: bool = True):
        self.name = name
        self.dtype = dtype
        self.primary_key = (primary_key,)
        self.pk = primary_key
        self.num_partitions = num_partitions
        self.flush_threshold = flush_threshold
        self.merge_policy = merge_policy or TieredMergePolicy()
        self.columnar = columnar            # False: legacy row components
        # ngram(k) indexes: field -> gram length; btree/rtree/keyword
        # indexes: field -> kind.  ALL secondary postings live on the
        # primary components (built at flush/merge), none in a secondary
        # LSM tree
        self._ngram_specs: Dict[str, int] = {}
        self._sec_kinds: Dict[str, str] = {}
        self.partitions: List[_Partition] = [
            _Partition(LSMIndex(flush_threshold, self.merge_policy,
                                schema=self.columnar_schema,
                                columnar=None if columnar else False,
                                ngram_fields=self._ngram_fields,
                                sec_fields=self._sec_fields))
            for _ in range(num_partitions)]
        self.index_fields: List[str] = []
        self.index_kinds: Dict[str, str] = {}   # btree|rtree|keyword|ngram
        self.spatial_cell_size = 0.05
        self.stats = {"inserts": 0, "deletes": 0, "bytes_encoded": 0}
        # columnar engine: open fields seen so far (name -> column kind)
        self._open_schema = ColumnSchema()
        self._declared = tuple(f.name for f in dtype.fields)
        # assembled-scan cache keyed by (partition, recovery epoch, LSM
        # version): the version is the snapshot-isolation key, so a query
        # over a pinned snapshot and a live read at the same version share
        # entries, and concurrent writers simply create entries under new
        # keys instead of invalidating a reader's.  GC keeps, per
        # partition, only the current version plus pinned ones (the epoch
        # keeps pre-crash entries from colliding after recovery replaces
        # the LSMIndex and resets its version counter).
        self._scan_cache: Dict[Tuple[int, int, int], Dict[str, Any]] = {}
        self._cache_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._batch_gate = _BatchGate()
        self._recover_epoch = 0
        self._schema_cache: Optional[Tuple[Any, ColumnSchema]] = None

    # -- DDL ---------------------------------------------------------------
    def _ngram_fields(self) -> Dict[str, int]:
        """Callable handed to the primary LSM indexes so components
        flushed/merged after a late ``create_index(..., "ngram")`` still
        get their postings built."""
        return dict(self._ngram_specs)

    def _sec_spec(self, fld: str) -> Tuple[str, Any]:
        """The (kind, param) postings spec for one secondary field.  The
        rtree spec carries the *current* grid cell size, so a changed
        ``spatial_cell_size`` rebuilds stale per-component postings on
        their next probe instead of serving wrong cells."""
        kind = self._sec_kinds[fld]
        return (kind, self.spatial_cell_size if kind == "rtree" else None)

    def _sec_fields(self) -> Dict[str, Tuple[str, Any]]:
        """Callable handed to the primary LSM indexes: flush/merge build
        btree/rtree/keyword CSR postings for these fields beside the
        component batch (the ngram calculus, generalized)."""
        return {fld: self._sec_spec(fld) for fld in self._sec_kinds}

    def create_index(self, fld: str, kind: str = "btree",
                     gram_length: int = 3) -> None:
        """Node-local secondary index.  Every kind registers *derived
        columnar postings* on the primary components (no secondary LSM
        tree): backfill here builds them for existing components,
        flush/merge keep them current, and the memtable tail is indexed
        at query time."""
        if fld in self.index_fields:
            raise adm.ValidationError(f"index on {fld} already exists")
        if kind not in ("ngram", "btree", "rtree", "keyword"):
            raise adm.ValidationError(kind)
        self.index_fields.append(fld)
        self.index_kinds[fld] = kind
        if kind == "ngram":
            self._ngram_specs[fld] = int(gram_length)
            for part in self.partitions:        # backfill existing comps
                for comp in part.primary.components:
                    if comp.valid:
                        comp.ensure_gram_postings(fld, int(gram_length))
            return
        self._sec_kinds[fld] = kind
        spec = self._sec_spec(fld)
        for part in self.partitions:            # backfill existing comps
            for comp in part.primary.components:
                if comp.valid:
                    comp.ensure_sec_postings(fld, spec)

    # -- DML (record-level transactions) ------------------------------------
    def insert(self, record: Dict[str, Any]) -> None:
        """Secondary postings are derived data on the components, so an
        insert is exactly one primary-index update — no old-version
        lookup, no per-index (key, pk) maintenance."""
        rec = self.dtype.validate(record)
        nbytes = len(self.dtype.encode(rec))
        self._open_schema.observe_row(rec, self._declared)
        key = rec[self.pk]
        part = self.partitions[hash_partition(key, self.num_partitions)]
        self._batch_gate.acquire_shared()
        try:
            part.primary.insert(key, rec)
        finally:
            self._batch_gate.release_shared()
        with self._stats_lock:
            self.stats["bytes_encoded"] += nbytes
            self.stats["inserts"] += 1

    def insert_batch(self, records: Sequence[Dict[str, Any]]) -> None:
        """One-statement batch (paper Table 4: amortizes per-statement
        overhead).  Records are validated and routed once, then applied
        to each partition as a bulk WAL+memtable pass
        (``LSMIndex.insert_batch``).  Secondary postings being derived
        component data, indexed datasets take the same bulk path as
        unindexed ones — no per-record old-version lookups.  This is the
        feed store path: micro-batches flow straight into memory
        components and flush columnar."""
        P = self.num_partitions
        buckets: List[Tuple[List[Any], List[Dict[str, Any]]]] = \
            [([], []) for _ in range(P)]
        validate = self.dtype.validate
        # no per-record ADM encode here: batch-ingested records land as
        # shredded columns at flush, not as encoded row bytes, so the
        # ``bytes_encoded`` (row-format) accounting applies only to the
        # per-record ``insert`` path
        recs: List[Dict[str, Any]] = []
        keys: List[Any] = []
        for record in records:
            rec = validate(record)
            self._open_schema.observe_row(rec, self._declared)
            recs.append(rec)
            keys.append(rec[self.pk])
        ids: Optional[List[int]] = None
        try:        # vectorized routing, placement-identical to the int
            arr = np.asarray(keys)      # branch of ``hash_partition``
            if arr.dtype.kind not in "iu":
                raise TypeError("non-int pks")
            ids = hash_partition_array(arr, P).tolist()
        except (TypeError, ValueError, OverflowError):
            ids = None
        for j, (key, rec) in enumerate(zip(keys, recs)):
            ks, rs = buckets[ids[j] if ids is not None
                             else hash_partition(key, P)]
            ks.append(key)
            rs.append(rec)
        # shared gate: concurrent batches still run in parallel, but a
        # snapshot pin (exclusive) can never observe half of this batch
        self._batch_gate.acquire_shared()
        try:
            for part, (ks, rs) in zip(self.partitions, buckets):
                if ks:
                    part.primary.insert_batch(ks, rs)
        finally:
            self._batch_gate.release_shared()
        with self._stats_lock:
            self.stats["inserts"] += len(records)

    def delete(self, key: Any) -> bool:
        part = self.partitions[hash_partition(key, self.num_partitions)]
        self._batch_gate.acquire_shared()
        try:
            with part.primary._lock:  # lookup+delete is one write step
                if part.primary.lookup(key) is None:
                    return False
                part.primary.delete(key)
        finally:
            self._batch_gate.release_shared()
        with self._stats_lock:
            self.stats["deletes"] += 1
        return True

    # -- read paths ----------------------------------------------------------
    def lookup(self, key: Any) -> Optional[Dict[str, Any]]:
        """Primary-key point lookup: routed to ONE partition (paper: record
        lookup hits a single node)."""
        part = self.partitions[hash_partition(key, self.num_partitions)]
        return part.primary.lookup(key)

    def scan_partition(self, i: int,
                       _view: Optional[LSMView] = None
                       ) -> List[Dict[str, Any]]:
        view = _view if _view is not None else self._view(i)
        return [row for _, row in view.items()]

    def scan(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for i in range(self.num_partitions):
            out.extend(self.scan_partition(i))
        return out

    # -- columnar read path --------------------------------------------------
    def columnar_schema(self) -> ColumnSchema:
        """Declared fields (from the RecordType) + open fields observed on
        insert, widened at read time by the per-component batch schemas —
        open-type drift between flushes (an int field turning string)
        surfaces here and unifies to ``obj``.  This is both the shred
        schema handed to the LSM layer at flush and the scan schema."""
        ver = (tuple(self._partition_version(i)
                     for i in range(self.num_partitions)),
               tuple(sorted(self._open_schema.kinds.items())))
        if self._schema_cache is not None and self._schema_cache[0] == ver:
            return self._schema_cache[1]
        sch = ColumnSchema.from_record_type(self.dtype) \
            .union(self._open_schema)
        for part in self.partitions:
            for comp in part.primary.components:
                if comp.valid and comp.batch is not None:
                    sch = sch.union(comp.batch.schema())
        self._schema_cache = (ver, sch)
        return sch

    def _partition_version(self, i: int) -> Tuple:
        return (self._recover_epoch, self.partitions[i].primary.version)

    def _view(self, i: int) -> LSMView:
        """Unfrozen point-in-time view of partition ``i`` (the default
        for every read path; concurrent readers pass a pinned view from a
        :class:`DatasetSnapshot` instead)."""
        return self.partitions[i].primary.current_view()

    def _cache_entry(self, i: int, view: LSMView) -> Dict[str, Any]:
        """The scan-cache entry for (partition, view-version): idx/keys
        live selection, assembled batches per projection, and memtable
        postings.  Creation GCs stale versions for the partition."""
        key = (i, self._recover_epoch, view.version)
        entry = self._scan_cache.get(key)
        if entry is None:
            with self._cache_lock:
                entry = self._scan_cache.get(key)
                if entry is None:
                    entry = self._scan_cache[key] = {
                        "idx": None, "keys": None, "batches": {},
                        "sec": {}, "ngram": {}}
                    self._cache_gc(i)
        return entry

    def _cache_gc(self, i: int) -> None:
        """Drop partition ``i`` cache entries whose version is neither
        current nor pinned by a live snapshot (called under
        ``_cache_lock``)."""
        prim = self.partitions[i].primary
        keep = set(prim.pinned_versions())
        keep.add(prim.version)
        epoch = self._recover_epoch
        for key in [k for k in self._scan_cache
                    if k[0] == i and (k[1] != epoch or k[2] not in keep)]:
            self._scan_cache.pop(key, None)

    def _cacheable(self, i: int, view: LSMView) -> bool:
        """An entry computed from a frozen (pinned) view is always safe
        to share; one computed from a live view is shared only if no
        writer raced the computation (else it may be torn — return it to
        this caller, never cache it)."""
        return view.frozen \
            or self.partitions[i].primary.version == view.version

    def _live_selection(self, i: int,
                        _view: Optional[LSMView] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Newest-wins live-row selection for partition ``i``: positions
        ``idx`` into the memtable+components concat (newest first) and the
        pk array ``keys`` aligned with them, both ordered by ascending pk.
        Cached per storage version; computed from keys + tombstone flags
        only — no record decode, no column shred."""
        view = _view if _view is not None else self._view(i)
        cache = self._cache_entry(i, view)
        if cache["idx"] is not None:
            return cache["idx"], cache["keys"]
        key_arrays: List[np.ndarray] = []
        tombs: List[np.ndarray] = []
        mem = view.memtable            # newest version of any key it holds
        if mem:
            key_arrays.append(key_array(list(mem)))
            tombs.append(np.fromiter((r is TOMBSTONE
                                      for r in mem.values()),
                                     dtype=bool, count=len(mem)))
        for comp in view.components:   # newest first
            if comp.size == 0:
                continue
            key_arrays.append(comp.keys)
            tombs.append(comp.tomb)
        if not key_arrays:
            idx = np.zeros(0, dtype=np.int64)
            keys: np.ndarray = np.zeros(0, dtype=np.int64)
        else:
            all_tomb = np.concatenate(tombs)
            all_keys: Optional[np.ndarray]
            # mixed dtypes promote on concat: require a lossless round-
            # trip (the guard the merge kernel shares) or fall back to
            # the exact python-scalar path below
            numeric = all(ka.dtype != object and ka.dtype.kind in "biuf"
                          for ka in key_arrays) \
                and promotes_lossless(key_arrays)
            if numeric:
                # numeric pks: one concat, no per-key python hop — the
                # component key arrays are already dense numeric
                all_keys = np.concatenate(key_arrays)
                _, idx = np.unique(all_keys, return_index=True)
            else:
                flat_keys = [k for ka in key_arrays for k in ka.tolist()]
                all_keys = key_array(flat_keys)   # lossless or object
                if all_keys.dtype != object:
                    # first occurrence in newest-first concat == newest
                    _, idx = np.unique(all_keys, return_index=True)
                else:
                    all_keys = None
                    seen = set()
                    first = []
                    for pos, k2 in enumerate(flat_keys):
                        if k2 not in seen:
                            seen.add(k2)
                            first.append((k2, pos))
                    first.sort(key=lambda t: t[0])
                    idx = np.asarray([p for _, p in first], dtype=np.int64)
            idx = idx[~all_tomb[idx]]
            if all_keys is not None:
                keys = all_keys[idx]
            else:
                keys = np.empty(len(idx), dtype=object)
                for j, pos in enumerate(idx.tolist()):
                    keys[j] = flat_keys[pos]
        if self._cacheable(i, view):
            # keys before idx: concurrent readers test idx for presence
            cache["keys"] = keys
            cache["idx"] = idx
        return idx, keys

    def partition_pk_array(self, i: int,
                           _view: Optional[LSMView] = None) -> np.ndarray:
        """Sorted live primary keys of partition ``i``, aligned row-for-row
        with ``scan_partition_batch(i, ...)``: element j is the pk of the
        scan batch's j-th record.  Sorted candidate-PK arrays from the
        secondary indexes intersect against this array to become position
        bitmaps over the cached ColumnBatches (columnar index access)."""
        return self._live_selection(i, _view)[1]

    def scan_partition_batch(self, i: int,
                             columns: Optional[Sequence[str]] = None,
                             _view: Optional[LSMView] = None
                             ) -> ColumnBatch:
        """Columnar scan of one partition, zero-copy over component
        storage: the immutable components' primary ColumnBatches are
        projected and concatenated as-is (string dictionaries remap onto
        the merged dictionary; mixed open-type kinds widen to ``obj``),
        then the vectorized newest-wins position selection — computed
        from key + tombstone arrays only — gathers live rows.  Nothing
        is shredded except the (mutable) memtable tail.  Row order
        (sorted by pk) and contents match ``scan_partition`` exactly."""
        view = _view if _view is not None else self._view(i)
        schema = self.columnar_schema()
        names = list(schema) if columns is None \
            else [c for c in columns if c in schema]
        idx, _ = self._live_selection(i, view)
        cache = self._cache_entry(i, view)
        ckey = tuple(names)
        cached = cache["batches"].get(ckey)
        if cached is not None:
            return cached
        batches: List[ColumnBatch] = []
        mem = view.memtable
        if mem:
            batches.append(ColumnBatch.from_rows(
                [({} if r is TOMBSTONE else r) for r in mem.values()],
                schema, names))
        for comp in view.components:   # newest first, as in _live_selection
            if comp.size == 0:
                continue
            batches.append(comp.as_batch(schema).project(names))
        if not batches:
            out = ColumnBatch.from_rows([], schema, names)
        else:
            out = ColumnBatch.concat(batches).take(idx)
        if self._cacheable(i, view):
            cache["batches"][ckey] = out
        return out

    # -- secondary postings probes (candidate reads) --------------------------
    def _require_sec(self, fld: str, kind: str) -> Tuple[str, Any]:
        if self._sec_kinds.get(fld) != kind:
            raise adm.ValidationError(
                f"no {kind} index on {self.name}.{fld}")
        return self._sec_spec(fld)

    def _sec_sources(self, i: int, fld: str, view: LSMView
                     ) -> Tuple[List[Tuple[int, Any]], int]:
        """(offset, FieldPostings) per storage tier of the view in
        ``_live_selection`` concat order (memtable first, then components
        newest-first) plus the concat length — the secondary twin of
        ``_ngram_sources``.  Component postings were built at flush/merge
        (``ensure_sec_postings`` is a no-op then); the mutable memtable
        tail is indexed here, cached per storage version."""
        spec = self._sec_spec(fld)
        sources: List[Tuple[int, Any]] = []
        off = 0
        mem = view.memtable
        if mem:
            # cache entries are keyed by storage version, so the
            # per-field memtable postings cached here can never be stale
            cache = self._cache_entry(i, view)["sec"]
            p = cache.get(fld)
            if p is None or p.spec != spec:
                vals = [None if r is TOMBSTONE else r.get(fld)
                        for r in mem.values()]
                p = FieldPostings.from_values(vals, spec)
                if self._cacheable(i, view):
                    cache[fld] = p
            sources.append((0, p))
            off = len(mem)
        for comp in view.components:           # newest first
            if comp.size == 0:
                continue
            sources.append((off, comp.ensure_sec_postings(fld, spec)))
            off += comp.size
        return sources, off

    @staticmethod
    def _positions_mask(parts: List[np.ndarray], total: int,
                        idx: np.ndarray) -> np.ndarray:
        """Candidate bitmap over live scan positions from per-tier posting
        segments: one scatter pass (the T-occurrence kernel K4 at
        threshold 1) over the storage concat, then the newest-wins
        selection — a stale old-version hit is simply never selected.
        ``parts`` holds offset host arrays or ``Segment`` s of resident
        posting arrays (the btree range probe's contiguous slices)."""
        from ..kernels.fuzzy_ops import Segment, t_occurrence_mask
        segs = [p if isinstance(p, Segment)
                else Segment(p, 0, int(p.shape[0]), 0) for p in parts]
        segs = [s for s in segs if s.stop > s.start]
        if not segs:
            return np.zeros(len(idx), dtype=bool)
        return t_occurrence_mask(segs, total, 1)[idx]

    def secondary_candidate_mask(self, i: int, fld: str, lo: Any, hi: Any,
                                 _view: Optional[LSMView] = None
                                 ) -> np.ndarray:
        """Secondary B+-tree range probe -> candidate bitmap over
        partition ``i``'s scan positions (aligned with
        ``scan_partition_batch`` / ``partition_pk_array``).  Per tier the
        probe is two binary searches over the sorted key dictionary and
        one contiguous positions slice — no (key, pk) pair is ever
        materialized and no python list is walked."""
        self._require_sec(fld, "btree")
        view = _view if _view is not None else self._view(i)
        idx, _ = self._live_selection(i, view)
        if not len(idx):
            return np.zeros(0, dtype=bool)
        from ..kernels.fuzzy_ops import Segment
        sources, total = self._sec_sources(i, fld, view)
        parts = [Segment(*p.range_segment(lo, hi), off)
                 for off, p in sources]
        return self._positions_mask(parts, total, idx)

    def secondary_fused_inputs(self, i: int, fld: str,
                               _view: Optional[LSMView] = None
                               ) -> Tuple[List[Tuple[int, Any]], int,
                                          np.ndarray]:
        """Raw operands for the fused Figure-6 chain dispatch
        (``columnar/plancache``): the per-tier ``(offset, FieldPostings)``
        sources, the storage concat length, and the live-selection index
        array — the same three inputs ``secondary_candidate_mask`` feeds
        through the per-operator scatter/gather path, returned unbaked so
        the whole probe -> bitmap -> gather can run as one jit dispatch
        over pooled device buffers."""
        self._require_sec(fld, "btree")
        view = _view if _view is not None else self._view(i)
        idx, _ = self._live_selection(i, view)
        sources, total = self._sec_sources(i, fld, view)
        return sources, total, idx

    def spatial_candidate_mask(self, i: int, fld: str,
                               center: Tuple[float, float],
                               radius: float,
                               _view: Optional[LSMView] = None
                               ) -> np.ndarray:
        """Grid ('rtree') probe -> candidate bitmap (post-validation still
        required: covering cells over-approximate the circle).  The
        covering cells are encoded and *deduplicated* once, then probed
        against each tier's sorted cell-code dictionary in one
        searchsorted + segment gather — overlapping cells are never
        scanned twice."""
        self._require_sec(fld, "rtree")
        view = _view if _view is not None else self._view(i)
        idx, _ = self._live_selection(i, view)
        if not len(idx):
            return np.zeros(0, dtype=bool)
        codes = cell_codes_for_query(
            cells_covering_circle(center, radius, self.spatial_cell_size))
        sources, total = self._sec_sources(i, fld, view)
        parts = [off + p.lookup_positions(codes) for off, p in sources]
        return self._positions_mask(parts, total, idx)

    def keyword_candidate_mask(self, i: int, fld: str, token: str,
                               fuzzy_ed: int = 0,
                               _view: Optional[LSMView] = None
                               ) -> np.ndarray:
        """Inverted-index probe -> candidate bitmap; ``fuzzy_ed > 0`` runs
        each tier's (distinct) token dictionary through one batched
        banded-DP call (kernels/fuzzy_ops) instead of a per-token python
        DP."""
        self._require_sec(fld, "keyword")
        view = _view if _view is not None else self._view(i)
        idx, _ = self._live_selection(i, view)
        if not len(idx):
            return np.zeros(0, dtype=bool)
        from ..kernels.fuzzy_ops import Segment
        token = token.lower()
        sources, total = self._sec_sources(i, fld, view)
        parts = [Segment(p.positions, a, b, off) for off, p in sources
                 for a, b in p.token_segments(token, fuzzy_ed)]
        return self._positions_mask(parts, total, idx)

    # sorted-PK candidate surfaces: the bitmap gathered through the live
    # pk array (ascending, so the result is sorted and deduplicated) —
    # one view serves both sides, so mask and pk array can never skew
    def secondary_candidate_pks(self, i: int, fld: str, lo: Any, hi: Any,
                                _view: Optional[LSMView] = None
                                ) -> np.ndarray:
        view = _view if _view is not None else self._view(i)
        return self.partition_pk_array(i, view)[
            self.secondary_candidate_mask(i, fld, lo, hi, view)]

    def spatial_candidate_pks(self, i: int, fld: str,
                              center: Tuple[float, float],
                              radius: float,
                              _view: Optional[LSMView] = None
                              ) -> np.ndarray:
        view = _view if _view is not None else self._view(i)
        return self.partition_pk_array(i, view)[
            self.spatial_candidate_mask(i, fld, center, radius, view)]

    def keyword_candidate_pks(self, i: int, fld: str, token: str,
                              fuzzy_ed: int = 0,
                              _view: Optional[LSMView] = None
                              ) -> np.ndarray:
        view = _view if _view is not None else self._view(i)
        return self.partition_pk_array(i, view)[
            self.keyword_candidate_mask(i, fld, token, fuzzy_ed, view)]

    # row-engine surfaces (paper §4.3: 'the result of a secondary key
    # lookup is a set of primary keys') — same postings probes, scalar
    # list out
    def secondary_search_partition(self, i: int, fld: str, lo: Any, hi: Any,
                                   _view: Optional[LSMView] = None
                                   ) -> List[Any]:
        return self.secondary_candidate_pks(i, fld, lo, hi, _view).tolist()

    def spatial_search_partition(self, i: int, fld: str,
                                 center: Tuple[float, float],
                                 radius: float,
                                 _view: Optional[LSMView] = None
                                 ) -> List[Any]:
        return self.spatial_candidate_pks(i, fld, center, radius,
                                          _view).tolist()

    def keyword_search_partition(self, i: int, fld: str, token: str,
                                 fuzzy_ed: int = 0,
                                 _view: Optional[LSMView] = None
                                 ) -> List[Any]:
        return self.keyword_candidate_pks(i, fld, token, fuzzy_ed,
                                          _view).tolist()

    # -- ngram (fuzzy) candidate generation -----------------------------------
    def _ngram_sources(self, i: int, fld: str, view: LSMView
                       ) -> Tuple[List[Tuple[int, Any]], int]:
        """(offset, GramPostings) per storage tier of the view in
        ``_live_selection`` concat order (memtable first, then components
        newest-first) plus the concat length.  Component postings were
        built at flush/merge (``ensure_gram_postings`` is a no-op then);
        the mutable memtable tail is indexed here, cached per storage
        version."""
        from ..fuzzy.ngram import GramPostings
        k = self._ngram_specs[fld]
        sources: List[Tuple[int, Any]] = []
        off = 0
        mem = view.memtable
        if mem:
            # cache entries are keyed by storage version, so a per-field
            # memtable postings cache in one can never be stale
            cache = self._cache_entry(i, view)["ngram"]
            p = cache.get(fld)
            if p is None:
                vals = [None if r is TOMBSTONE else r.get(fld)
                        for r in mem.values()]
                p = GramPostings.from_values(vals, k)
                if self._cacheable(i, view):
                    cache[fld] = p
            sources.append((0, p))
            off = len(mem)
        for comp in view.components:           # newest first
            if comp.size == 0:
                continue
            sources.append((off, comp.ensure_gram_postings(fld, k)))
            off += comp.size
        return sources, off

    def ngram_candidate_mask(self, i: int, fld: str, spec: Tuple,
                             _view: Optional[LSMView] = None
                             ) -> np.ndarray:
        """T-occurrence candidate bitmap over partition ``i``'s scan
        positions (aligned with ``scan_partition_batch`` /
        ``partition_pk_array``): the gram-hit posting segments of every
        storage tier go to one count kernel (K4), which keeps positions
        with >= T hits.  T <= 0 means the index cannot prune — every row
        with an indexable value is a candidate.  Each segment is a slice
        of its tier's immutable positions array (:class:`Segment`), so a
        warm probe over component postings ships no positions to the
        device."""
        from ..fuzzy.ngram import query_grams
        from ..kernels.fuzzy_ops import t_occurrence_mask
        if fld not in self._ngram_specs:
            raise adm.ValidationError(f"no ngram index on {self.name}.{fld}")
        view = _view if _view is not None else self._view(i)
        idx, _ = self._live_selection(i, view)
        if not len(idx):
            return np.zeros(0, dtype=bool)
        qh, threshold = query_grams(spec, self._ngram_specs[fld])
        sources, total = self._ngram_sources(i, fld, view)
        if threshold <= 0:
            has = np.zeros(total, dtype=bool)
            for off, p in sources:
                has[off:off + p.n_rows] = p.has_value
            return has[idx]
        segs = [s for off, p in sources for s in p.hit_segments(qh, off)]
        return t_occurrence_mask(segs, total, threshold)[idx]

    def ngram_search_partition(self, i: int, fld: str, spec: Tuple,
                               _view: Optional[LSMView] = None
                               ) -> List[Tuple[Any, int]]:
        """Row-engine surface: (pk, gram hits) per candidate row — rows
        with any gram hit, plus (when T <= 0, so hits cannot prune) every
        row holding an indexable value.  The T_OCCURRENCE operator
        filters by threshold; counts here are host bincounts, the fused
        kernel belongs to the columnar path."""
        from ..fuzzy.ngram import query_grams
        if fld not in self._ngram_specs:
            raise adm.ValidationError(f"no ngram index on {self.name}.{fld}")
        view = _view if _view is not None else self._view(i)
        idx, keys = self._live_selection(i, view)
        if not len(idx):
            return []
        qh, threshold = query_grams(spec, self._ngram_specs[fld])
        sources, total = self._ngram_sources(i, fld, view)
        counts = np.zeros(total, dtype=np.int64)
        has = np.zeros(total, dtype=bool)
        for off, p in sources:
            has[off:off + p.n_rows] = p.has_value
            hp = p.hit_positions(qh)
            if len(hp):
                counts[off:off + p.n_rows] += np.bincount(
                    hp, minlength=p.n_rows)
        live_counts = counts[idx]
        live_has = has[idx]
        emit = (live_counts > 0) | live_has if threshold <= 0 \
            else live_counts > 0
        return [(pk, int(c)) for pk, c, e in
                zip(keys.tolist(), live_counts.tolist(), emit.tolist())
                if e]

    def primary_lookup_partition(self, i: int, pks: Sequence[Any],
                                 _view: Optional[LSMView] = None
                                 ) -> List[Dict[str, Any]]:
        """Sorted-PK batched primary lookups (Figure 6's SORT_PK step makes
        this access pattern sequential on a real B+-tree).  The plan's
        SORT_PK already ordered the candidates, so an in-order input is
        detected with one linear pass instead of being re-sorted."""
        prim = _view if _view is not None else self.partitions[i].primary
        pks = list(pks)
        try:
            unsorted = any(pks[j] > pks[j + 1] for j in range(len(pks) - 1))
        except TypeError:           # mixed-type pks: let sorted() decide
            unsorted = True
        if unsorted:
            pks = sorted(pks)
        out = []
        for pk in pks:
            row = prim.lookup(pk)
            if row is not None:
                out.append(row)
        return out

    # -- recovery -------------------------------------------------------------
    def crash_and_recover(self) -> "PartitionedDataset":
        """Simulate a crash: rebuild every partition from (valid components +
        WAL), discarding unflushed memtables and invalid components.
        Secondary postings are component data, so they survive (or are
        dropped) with their components — there is no secondary recovery
        pass, and the replayed memtable tail is re-indexed at query
        time."""
        self._recover_epoch += 1     # recovered indexes restart counters
        for part in self.partitions:
            part.primary = recover(part.primary.components, part.primary.wal,
                                   flush_threshold=self.flush_threshold,
                                   schema=self.columnar_schema,
                                   columnar=None if self.columnar else False,
                                   ngram_fields=self._ngram_fields,
                                   sec_fields=self._sec_fields)
        return self

    # -- snapshot isolation ---------------------------------------------------
    def pin(self) -> "DatasetSnapshot":
        """Pin a snapshot-isolated read view of every partition (paper
        §2.4: queries serve against one consistent LSM state while feeds
        keep ingesting).  Use as a context manager, or call
        ``release()`` when done so replaced components can physically
        retire."""
        return DatasetSnapshot(self)

    def __len__(self) -> int:
        return sum(len(p.primary) for p in self.partitions)


class DatasetSnapshot:
    """Snapshot-isolated read facade over a :class:`PartitionedDataset`.

    Pins one refcounted :class:`~repro.core.lsm.LSMView` per partition
    (``LSMIndex.pin()``) and exposes the dataset's entire *read* surface
    — row scans, columnar scans, candidate masks/PKs, ngram probes,
    primary lookups — bound to those frozen views, so a whole query plan
    (row or columnar engine) executes against one consistent LSM state
    end to end while writers proceed.  Duck-types the dataset for the
    executor and the columnar lowering: configuration attributes
    (``name``, ``num_partitions``, index registries, ...) delegate to the
    underlying dataset, mutators raise.  Scan-cache entries are shared
    with the live dataset through the (partition, epoch, version) key,
    so repeated queries over one snapshot — or a snapshot and a live
    read at the same version — reuse the same assembled batches.
    """

    def __init__(self, ds: PartitionedDataset):
        self._ds = ds
        # exclusive gate: waits out in-flight insert/insert_batch/delete
        # calls so the per-partition pins form one batch-consistent cut —
        # never half of a multi-partition micro-batch
        ds._batch_gate.acquire_exclusive()
        try:
            self._views: List[LSMView] = [p.primary.pin()
                                          for p in ds.partitions]
        finally:
            ds._batch_gate.release_exclusive()
        self._released = False

    # -- lifecycle -----------------------------------------------------------
    @property
    def versions(self) -> Tuple[int, ...]:
        """Per-partition pinned LSM versions (the snapshot identity)."""
        return tuple(v.version for v in self._views)

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> None:
        """Unpin every partition view (idempotent): deferred component
        retirements owed to this snapshot happen here."""
        if self._released:
            return
        self._released = True
        for v in self._views:
            v.release()

    def __enter__(self) -> "DatasetSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- config passthrough (executor/lowering/catalog probes) ---------------
    def __getattr__(self, name: str):
        # only called for attributes not defined on the snapshot: config
        # and registry reads delegate; everything stateful is explicit
        if name.startswith("_abc"):
            raise AttributeError(name)
        return getattr(self._ds, name)

    def _blocked(self, *a, **k):
        raise TypeError("DatasetSnapshot is read-only — writes go to the "
                        "live PartitionedDataset")

    insert = insert_batch = delete = create_index = _blocked
    crash_and_recover = _blocked

    def pin(self) -> "DatasetSnapshot":
        raise TypeError("cannot pin a DatasetSnapshot — pin the live "
                        "PartitionedDataset")

    # -- read surface, bound to the pinned views -----------------------------
    def lookup(self, key: Any) -> Optional[Dict[str, Any]]:
        i = hash_partition(key, self._ds.num_partitions)
        return self._views[i].lookup(key)

    def scan_partition(self, i: int) -> List[Dict[str, Any]]:
        return self._ds.scan_partition(i, _view=self._views[i])

    def scan(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for i in range(self._ds.num_partitions):
            out.extend(self.scan_partition(i))
        return out

    def partition_pk_array(self, i: int) -> np.ndarray:
        return self._ds.partition_pk_array(i, _view=self._views[i])

    def scan_partition_batch(self, i: int,
                             columns: Optional[Sequence[str]] = None
                             ) -> ColumnBatch:
        return self._ds.scan_partition_batch(i, columns,
                                             _view=self._views[i])

    def secondary_candidate_mask(self, i: int, fld: str, lo: Any, hi: Any
                                 ) -> np.ndarray:
        return self._ds.secondary_candidate_mask(i, fld, lo, hi,
                                                 _view=self._views[i])

    def secondary_fused_inputs(self, i: int, fld: str):
        # explicit (not __getattr__): the fused chain must see *this*
        # snapshot's pinned view, not a freshly-taken one
        return self._ds.secondary_fused_inputs(i, fld,
                                               _view=self._views[i])

    def spatial_candidate_mask(self, i: int, fld: str,
                               center: Tuple[float, float],
                               radius: float) -> np.ndarray:
        return self._ds.spatial_candidate_mask(i, fld, center, radius,
                                               _view=self._views[i])

    def keyword_candidate_mask(self, i: int, fld: str, token: str,
                               fuzzy_ed: int = 0) -> np.ndarray:
        return self._ds.keyword_candidate_mask(i, fld, token, fuzzy_ed,
                                               _view=self._views[i])

    def secondary_candidate_pks(self, i: int, fld: str, lo: Any, hi: Any
                                ) -> np.ndarray:
        return self._ds.secondary_candidate_pks(i, fld, lo, hi,
                                                _view=self._views[i])

    def spatial_candidate_pks(self, i: int, fld: str,
                              center: Tuple[float, float],
                              radius: float) -> np.ndarray:
        return self._ds.spatial_candidate_pks(i, fld, center, radius,
                                              _view=self._views[i])

    def keyword_candidate_pks(self, i: int, fld: str, token: str,
                              fuzzy_ed: int = 0) -> np.ndarray:
        return self._ds.keyword_candidate_pks(i, fld, token, fuzzy_ed,
                                              _view=self._views[i])

    def secondary_search_partition(self, i: int, fld: str, lo: Any, hi: Any
                                   ) -> List[Any]:
        return self._ds.secondary_search_partition(i, fld, lo, hi,
                                                   _view=self._views[i])

    def spatial_search_partition(self, i: int, fld: str,
                                 center: Tuple[float, float],
                                 radius: float) -> List[Any]:
        return self._ds.spatial_search_partition(i, fld, center, radius,
                                                 _view=self._views[i])

    def keyword_search_partition(self, i: int, fld: str, token: str,
                                 fuzzy_ed: int = 0) -> List[Any]:
        return self._ds.keyword_search_partition(i, fld, token, fuzzy_ed,
                                                 _view=self._views[i])

    def ngram_candidate_mask(self, i: int, fld: str, spec: Tuple
                             ) -> np.ndarray:
        return self._ds.ngram_candidate_mask(i, fld, spec,
                                             _view=self._views[i])

    def ngram_search_partition(self, i: int, fld: str, spec: Tuple
                               ) -> List[Tuple[Any, int]]:
        return self._ds.ngram_search_partition(i, fld, spec,
                                               _view=self._views[i])

    def primary_lookup_partition(self, i: int, pks: Sequence[Any]
                                 ) -> List[Dict[str, Any]]:
        return self._ds.primary_lookup_partition(i, pks,
                                                 _view=self._views[i])

    def __len__(self) -> int:
        return sum(int(self.partition_pk_array(i).shape[0])
                   for i in range(self._ds.num_partitions))
