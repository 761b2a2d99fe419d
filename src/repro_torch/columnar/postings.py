"""Columnar secondary-index postings: per-component CSR structures for the
btree / rtree(grid) / keyword index kinds (paper §4.1), generalizing the
fuzzy subsystem's ngram ``GramPostings``.

Like ngram postings, these are *derived columnar data* carried by every
primary LSM component (built at flush/merge beside the component's
ColumnBatch, adopted as-is by recovery, backfilled by a late
``create_index``) — not a separate LSM tree of (key, pk) rows.  The
structure per indexed field is a CSR over component-local row positions:

  keys       sorted distinct key dictionary.  btree: the field's values
             in their *physical* column domain (int64 epoch micros for
             datetimes, dictionary strings for str columns, raw python
             scalars for ``obj`` drift); rtree: uint64-encoded grid-cell
             codes; keyword: sorted distinct token strings
  offsets    int64 [K+1] segment bounds into ``positions``
  positions  int64 component-local row positions, grouped by key (one
             entry per (distinct key, row) pair; btree/rtree rows appear
             exactly once, keyword rows once per distinct token)
  has_value  bool [n_rows]: row holds an indexable value at all

Because ``keys`` is sorted, a btree range probe is two binary searches
plus ONE contiguous ``positions`` slice; rtree circle probes and keyword
token probes are a searchsorted against a (deduplicated) probe-key array
plus one vectorized segment gather.  Candidate *bitmaps* then come from a
single scatter pass (``kernels.fuzzy_ops.t_occurrence_mask`` with
threshold 1 — the same kernel the ngram T-occurrence path dispatches),
composed with the dataset's newest-wins live-row selection exactly the
way ngram candidate masks are: stale old-version positions are simply
never selected, so no per-(key, pk) tombstone maintenance is needed.

The CSR assembly (``csr_from_pairs``) and the vectorized segment
expansion (``segment_gather``) here are the shared builders the ngram
module now imports — one copy of the pattern for all four index kinds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..core.functions import spatial_cell, word_tokens
from .batch import pow2_len
from .schema import encode_scalar

__all__ = ["FieldPostings", "csr_from_pairs", "segment_gather",
           "encode_cells", "cell_codes_for_query"]

_EMPTY_I64 = np.zeros(0, dtype=np.int64)

# numeric physical domains whose keys sort/probe as plain ndarrays
_NUMERIC_DOMAINS = frozenset({"i64", "f64", "bool", "dt", "date"})

_CELL_OFF = np.int64(2 ** 31)          # grid coords recentered to >= 0


def segment_gather(src: np.ndarray, starts: np.ndarray,
                   counts: np.ndarray) -> np.ndarray:
    """Concatenate ``src[starts[i]:starts[i]+counts[i]]`` segments in one
    vectorized gather — the CSR expansion every postings build and every
    multi-key probe share (hoisted from fuzzy/ngram)."""
    total = int(counts.sum())
    if total == 0:
        return src[:0]
    excl = np.concatenate([np.zeros(1, dtype=np.int64),
                           np.cumsum(counts)[:-1]])
    idx = np.repeat(starts - excl, counts) + np.arange(total)
    return src[idx]


def csr_from_pairs(all_keys: np.ndarray, all_pos: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sorted distinct keys, offsets [K+1], positions grouped by key)
    from parallel (key, position) pair arrays.  Works for any key dtype
    numpy can argsort — uint64 gram hashes, int64/float columns, object
    arrays of strings."""
    if all_keys.shape[0] == 0:
        return all_keys, np.zeros(1, dtype=np.int64), _EMPTY_I64
    order = np.argsort(all_keys, kind="stable")
    keys, counts = np.unique(all_keys[order], return_counts=True)
    offsets = np.zeros(keys.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return keys, offsets, all_pos[order].astype(np.int64)


def encode_cells(xs: np.ndarray, ys: np.ndarray, cell: float) -> np.ndarray:
    """uint64 grid-cell codes for point coordinate arrays: one sortable
    scalar per cell, bit-identical placement to ``spatial_cell``."""
    cx = np.floor(xs / cell).astype(np.int64) + _CELL_OFF
    cy = np.floor(ys / cell).astype(np.int64) + _CELL_OFF
    return (cx.astype(np.uint64) << np.uint64(32)) | cy.astype(np.uint64)


def _cell_code(c: Tuple[int, int]) -> int:
    # one copy of the encoding: build (encode_cells) and probe must stay
    # bit-identical or rtree probes silently return empty
    off = int(_CELL_OFF)
    return ((int(c[0]) + off) << 32) | (int(c[1]) + off)


def cell_codes_for_query(cells: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Sorted *deduplicated* cell-code probe array.  Deduplicating here —
    before any postings probe — is what keeps overlapping covering-cell
    candidates from being scanned twice (each cell's posting segment is
    gathered exactly once)."""
    if not cells:
        return np.zeros(0, dtype=np.uint64)
    return np.unique(np.asarray([_cell_code(c) for c in cells],
                                dtype=np.uint64))


def _obj_array(items: Sequence[Any]) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        out[i] = x
    return out


@dataclass
class FieldPostings:
    """Per-component columnar CSR postings for one secondary-indexed
    field (immutable, like the component batch it sits beside).

    ``spec`` is the index spec the structure was built for — ``("btree",
    None)``, ``("rtree", cell_size)`` or ``("keyword", None)`` — so a
    changed spec (e.g. a new grid cell size) rebuilds instead of serving
    stale cells.  ``domain`` names the key representation: a physical
    column kind for btree keys, ``"cell"`` for rtree codes, ``"token"``
    for keyword strings, ``"obj"`` for raw python fallback keys.
    ``ordered`` is False only when an obj-domain key set refused a total
    order (mixed incomparable types) — range probes then filter the key
    dictionary per key instead of slicing."""

    spec: Tuple[str, Any]
    domain: str
    keys: np.ndarray
    offsets: np.ndarray       # int64 [K+1]
    positions: np.ndarray     # int64 row positions, grouped by key
    has_value: np.ndarray     # bool [n_rows]
    n_rows: int
    ordered: bool = True
    # pow2-padded positions view, built once per immutable postings
    # (Column.padded idiom): stable identity == stable device-pool key
    _padded: Optional[np.ndarray] = field(default=None, repr=False,
                                          compare=False)

    # -- constructors -------------------------------------------------------
    @classmethod
    def _empty(cls, spec: Tuple[str, Any], domain: str,
               has_value: np.ndarray) -> "FieldPostings":
        return cls(spec, domain, _EMPTY_I64, np.zeros(1, dtype=np.int64),
                   _EMPTY_I64, has_value, int(has_value.shape[0]))

    @classmethod
    def from_values(cls, vals: Sequence[Any],
                    spec: Tuple[str, Any]) -> "FieldPostings":
        """Build from python values (memtable tail, obj-kind columns,
        row-mode components).  This is build-time work — probes never
        touch python values again."""
        kind = spec[0]
        if kind == "btree":
            return cls._btree_from_values(vals, spec)
        if kind == "rtree":
            return cls._rtree_from_values(vals, spec)
        if kind == "keyword":
            return cls._keyword_from_values(vals, spec)
        raise ValueError(f"unknown postings kind {kind!r}")

    @classmethod
    def from_batch(cls, batch: Any, fld: str, spec: Tuple[str, Any],
                   n_rows: int) -> "FieldPostings":
        """Build from the component's shredded column: numeric and
        dictionary-coded columns assemble without decoding a single
        value; obj columns fall back to the value path."""
        col = batch.columns.get(fld)
        if col is None:
            dom = {"btree": "obj", "rtree": "cell",
                   "keyword": "token"}[spec[0]]
            return cls._empty(spec, dom, np.zeros(n_rows, dtype=bool))
        kind = spec[0]
        if kind == "keyword":
            return cls.keyword_from_column(col, spec, n_rows)
        if kind == "btree":
            if col.kind in _NUMERIC_DOMAINS:
                pos = np.nonzero(col.valid)[0].astype(np.int64)
                data = col.data[pos]
                if col.kind == "bool":
                    data = data.astype(np.int64)
                keys, offsets, positions = csr_from_pairs(data, pos)
                return cls(spec, col.kind, keys, offsets, positions,
                           col.valid.copy(), n_rows)
            if col.kind == "str":
                vals = col.values or []
                pos = np.nonzero(col.valid)[0].astype(np.int64)
                codes = col.data[pos].astype(np.int64)
                order = np.argsort(codes, kind="stable")
                counts = np.bincount(codes, minlength=len(vals)) \
                    if pos.shape[0] else np.zeros(len(vals), dtype=np.int64)
                offsets = np.zeros(len(vals) + 1, dtype=np.int64)
                np.cumsum(counts, out=offsets[1:])
                # dictionary is sorted, so it IS the key dictionary
                return cls(spec, "str", _obj_array(vals), offsets,
                           pos[order], col.valid.copy(), n_rows)
        decoded = col.decode()
        return cls.from_values(
            [v if not _missing(v) else None for v in decoded], spec)

    @classmethod
    def _btree_from_values(cls, vals: Sequence[Any],
                           spec: Tuple[str, Any]) -> "FieldPostings":
        from .schema import infer_kind, unify_kinds
        n = len(vals)
        has = np.fromiter((v is not None for v in vals), dtype=bool,
                          count=n)
        pos = np.nonzero(has)[0].astype(np.int64)
        raw = [vals[int(i)] for i in pos]
        if not raw:
            return cls._empty(spec, "obj", has)
        dom: Optional[str] = None
        for v in raw:
            dom = unify_kinds(dom, infer_kind(v))
        if dom in _NUMERIC_DOMAINS:
            data = np.asarray([encode_scalar(v, dom) for v in raw],
                              dtype=np.int64 if dom != "f64"
                              else np.float64)
            keys, offsets, positions = csr_from_pairs(data, pos)
            return cls(spec, dom, keys, offsets, positions, has, n)
        if dom == "str":
            keys, offsets, positions = csr_from_pairs(_obj_array(raw), pos)
            return cls(spec, "str", keys, offsets, positions, has, n)
        arr = _obj_array(raw)
        try:
            keys, offsets, positions = csr_from_pairs(arr, pos)
            return cls(spec, "obj", keys, offsets, positions, has, n)
        except TypeError:
            # incomparable mixed types: group by (type, repr) order —
            # range probes detect ``ordered=False`` and filter per key
            order = sorted(range(len(raw)),
                           key=lambda j: (type(raw[j]).__name__,
                                          repr(raw[j])))
            keys_l: List[Any] = []
            counts_l: List[int] = []
            for j in order:
                if keys_l and raw[j] == keys_l[-1] \
                        and type(raw[j]) is type(keys_l[-1]):
                    counts_l[-1] += 1
                else:
                    keys_l.append(raw[j])
                    counts_l.append(1)
            offsets = np.zeros(len(keys_l) + 1, dtype=np.int64)
            np.cumsum(np.asarray(counts_l, dtype=np.int64),
                      out=offsets[1:])
            positions = pos[np.asarray(order, dtype=np.int64)]
            return cls(spec, "obj", _obj_array(keys_l), offsets,
                       positions, has, n, ordered=False)

    @classmethod
    def _rtree_from_values(cls, vals: Sequence[Any],
                           spec: Tuple[str, Any]) -> "FieldPostings":
        cell = float(spec[1])
        n = len(vals)
        has = np.fromiter(
            (isinstance(v, (tuple, list)) and len(v) == 2 for v in vals),
            dtype=bool, count=n)
        pos = np.nonzero(has)[0].astype(np.int64)
        if pos.shape[0] == 0:
            return cls._empty(spec, "cell", has)
        pts = [vals[int(i)] for i in pos]
        try:
            xy = np.asarray(pts, dtype=np.float64)
            codes = encode_cells(xy[:, 0], xy[:, 1], cell)
        except (TypeError, ValueError):
            codes = np.asarray([_cell_code(spatial_cell(p, cell))
                                for p in pts], dtype=np.uint64)
        keys, offsets, positions = csr_from_pairs(codes, pos)
        return cls(spec, "cell", keys, offsets, positions, has, n)

    @classmethod
    def _keyword_from_values(cls, vals: Sequence[Any],
                             spec: Tuple[str, Any]) -> "FieldPostings":
        n = len(vals)
        cache = {}
        per_row: List[List[str]] = []
        has = np.zeros(n, dtype=bool)
        for i, v in enumerate(vals):
            if isinstance(v, str):
                toks = cache.get(v)
                if toks is None:
                    cache[v] = toks = sorted(set(word_tokens(v)))
                per_row.append(toks)
                has[i] = True
            else:
                per_row.append([])
        counts = np.fromiter((len(t) for t in per_row), np.int64, count=n)
        total = int(counts.sum())
        if total == 0:
            return cls._empty(spec, "token", has)
        all_toks = _obj_array([t for toks in per_row for t in toks])
        all_pos = np.repeat(np.arange(n, dtype=np.int64), counts)
        keys, offsets, positions = csr_from_pairs(all_toks, all_pos)
        return cls(spec, "token", keys, offsets, positions, has, n)

    @classmethod
    def keyword_from_column(cls, col: Any, spec: Tuple[str, Any],
                            n_rows: int) -> "FieldPostings":
        """Dictionary-coded build: tokenize once per *distinct* string and
        expand to rows by gathering code segments (the GramPostings
        pattern with tokens instead of gram hashes)."""
        if col.kind != "str":
            return cls.from_values(
                [v if isinstance(v, str) else None for v in col.decode()],
                spec)
        vals = col.values or []
        per_val = [sorted(set(word_tokens(v))) for v in vals]
        vcounts = np.fromiter((len(t) for t in per_val), np.int64,
                              count=len(vals))
        voffs = np.zeros(len(vals) + 1, dtype=np.int64)
        np.cumsum(vcounts, out=voffs[1:])
        flat = _obj_array([t for toks in per_val for t in toks])
        has = col.valid.copy()
        pos = np.nonzero(col.valid)[0].astype(np.int64)
        if pos.shape[0] == 0:
            return cls._empty(spec, "token", has)
        codes = col.data[pos].astype(np.int64)
        counts = vcounts[codes]
        if int(counts.sum()) == 0:
            return cls._empty(spec, "token", has)
        all_toks = segment_gather(flat, voffs[codes], counts)
        all_pos = np.repeat(pos, counts)
        keys, offsets, positions = csr_from_pairs(all_toks, all_pos)
        return cls(spec, "token", keys, offsets, positions, has, n_rows)

    # -- probes -------------------------------------------------------------
    def _encode_bound(self, v: Any, is_lo: bool) -> Any:
        """Map a raw probe bound into the key domain.  Integer bounds on
        f64 keys widen; fractional bounds on integer keys round *inward*
        (ceil for lo, floor for hi) so the slice stays exact.  Raises on
        anything else — the caller falls back to the per-key filter."""
        dom = self.domain
        if dom == "f64":
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise TypeError(v)
            return float(v)
        if dom in ("i64", "bool"):
            if isinstance(v, bool):
                return int(v)
            if isinstance(v, int):
                return v
            if isinstance(v, float):
                return math.ceil(v) if is_lo else math.floor(v)
            raise TypeError(v)
        if dom in ("dt", "date"):
            return encode_scalar(v, dom)
        if dom in ("str", "token"):
            if not isinstance(v, str):
                raise TypeError(v)
            return v
        return v                      # obj domain: probe with raw values

    def range_offsets(self, lo: Any, hi: Any) -> Optional[Tuple[int, int]]:
        """Positions-slice bounds ``[a, b)`` covering keys in [lo, hi]
        (raw, unencoded bounds; None = unbounded): two binary searches
        over the key dictionary.  Returns None when the dictionary is
        unordered or a bound cannot be encoded — callers fall back to
        the per-key filter.  The scalar pair (rather than the slice
        itself) is what the fused chain ships to the device, so the
        pooled ``padded_positions`` array stays the only big operand."""
        if not self.ordered:
            return None
        if self.keys.shape[0] == 0:
            return (0, 0)
        try:
            i = 0 if lo is None else int(
                np.searchsorted(self.keys, self._encode_bound(lo, True),
                                side="left"))
            j = self.keys.shape[0] if hi is None else int(
                np.searchsorted(self.keys, self._encode_bound(hi, False),
                                side="right"))
        except (TypeError, ValueError, OverflowError):
            return None
        if j <= i:
            return (0, 0)
        return (int(self.offsets[i]), int(self.offsets[j]))

    def range_segment(self, lo: Any, hi: Any
                      ) -> Tuple[np.ndarray, int, int]:
        """Row positions whose key falls in [lo, hi], as ``(array, start,
        stop)``: one contiguous slice of the postings' own (immutable,
        device-pool resident) positions array via ``range_offsets``, so
        the probe ships no positions to the device — or the per-key
        filter's result when the bounds defeat the sorted dictionary."""
        ab = self.range_offsets(lo, hi)
        if ab is None:
            got = self._filter_positions(lo, hi)
            return got, 0, int(got.shape[0])
        return self.positions, ab[0], max(ab)

    def padded_positions(self) -> np.ndarray:
        """Pow2-padded positions array, built once per immutable postings
        (``Column.padded`` idiom).  Padding lanes are zero and must be
        masked by the caller's ``[a, b)`` slice bounds (the fused chain
        selects lanes by offset, so padding never counts); the stable
        identity makes this a device-pool key for the component's whole
        lifetime."""
        if self._padded is None:
            n = int(self.positions.shape[0])
            np2 = pow2_len(n)
            if np2 == n and n > 0:
                self._padded = self.positions
            else:
                pad = np.zeros(max(np2, 1), dtype=np.int64)
                pad[:n] = self.positions
                self._padded = pad
        return self._padded

    def _filter_positions(self, lo: Any, hi: Any) -> np.ndarray:
        """Per-key fallback over the (small, distinct) key dictionary for
        bounds the domain cannot encode; incomparable keys never match."""
        from .schema import decode_scalar
        dec = [decode_scalar(k, self.domain)
               if self.domain in ("dt", "date") else k
               for k in self.keys.tolist()]
        sel = np.zeros(len(dec), dtype=bool)
        for idx, k in enumerate(dec):
            try:
                sel[idx] = (lo is None or k >= lo) \
                    and (hi is None or k <= hi)
            except TypeError:
                sel[idx] = False
        if not sel.any():
            return _EMPTY_I64
        starts = self.offsets[:-1][sel]
        counts = self.offsets[1:][sel] - starts
        return segment_gather(self.positions, starts, counts)

    def lookup_positions(self, probe_keys: np.ndarray) -> np.ndarray:
        """Row positions under any of the (sorted, deduplicated) probe
        keys: searchsorted both sides, one vectorized segment gather."""
        if self.keys.shape[0] == 0 or probe_keys.shape[0] == 0:
            return _EMPTY_I64
        lo = np.searchsorted(self.keys, probe_keys, side="left")
        hi = np.searchsorted(self.keys, probe_keys, side="right")
        found = hi > lo
        if not found.any():
            return _EMPTY_I64
        starts = self.offsets[lo[found]]
        counts = self.offsets[lo[found] + 1] - starts
        return segment_gather(self.positions, starts, counts)

    def token_segments(self, token: str, fuzzy_ed: int = 0
                       ) -> List[Tuple[int, int]]:
        """Keyword probe: ``(start, stop)`` slices of the postings' own
        (immutable, device-pool resident) positions array, one per
        matching token, so the probe ships no positions to the device.
        With ``fuzzy_ed`` the whole (distinct) token dictionary runs
        through one batched banded-DP call (K5); a row under several
        matching tokens sits in several slices, which the T = 1 count
        (K4) collapses."""
        if self.keys.shape[0] == 0:
            return []
        if fuzzy_ed == 0:
            probe = _obj_array([token])
            lo = int(np.searchsorted(self.keys, probe, side="left")[0])
            hi = int(np.searchsorted(self.keys, probe, side="right")[0])
            sel = range(lo, hi)
        else:
            from ..kernels.fuzzy_ops import edit_distances
            sel = np.flatnonzero(edit_distances(self.keys.tolist(), token,
                                                fuzzy_ed) <= fuzzy_ed)
        return [(int(self.offsets[g]), int(self.offsets[g + 1]))
                for g in sel]


def _missing(v: Any) -> bool:
    from .batch import MISSING
    return v is MISSING or v is None
