"""ColumnBatch: the columnar record format (dense arrays + validity
bitmaps + per-column sorted string dictionaries).

One ColumnBatch holds N shredded ADM records.  Every column carries a
validity bitmap (False = field absent in that record) so open types and
optional fields round-trip losslessly: ``ColumnBatch.from_rows(rows)
.to_rows() == rows`` for anything core/adm validates, with
present-but-null and non-scalar values riding in ``obj`` columns.

String columns dictionary-encode against a *sorted* per-batch dictionary,
so code order equals lexicographic order and range predicates evaluate
directly on the int32 codes.

ColumnBatch is also the *primary* on-disk representation of immutable
LSM components (core/lsm): flush shreds the memtable in sorted-key order
(``sort_by`` is the batch-level counterpart for callers holding an
already-shredded batch), ``merge_sorted`` gathers a column-wise k-way
merge from the ``sorted_merge_take`` kernel's take-indices, and every
column caches a pow2-padded view of its arrays (``Column.padded``) so
the jitted kernels see a bounded, shape-stable set of operand shapes
across repeated scans and merges.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from .schema import ColumnSchema, decode_scalar, encode_scalar, infer_kind, \
    unify_kinds

__all__ = ["Column", "ColumnBatch", "MISSING", "pow2_len",
           "promotes_lossless"]


class _Missing:
    def __repr__(self) -> str:
        return "<MISSING>"


MISSING = _Missing()

_NP_DTYPE = {"i64": np.int64, "f64": np.float64, "bool": np.bool_,
             "dt": np.int64, "date": np.int64, "str": np.int32}


def pow2_len(n: int) -> int:
    """Smallest power of two >= n (and >= 1): the shape-stable storage
    granule for kernel operands."""
    return 1 << max(0, (n - 1).bit_length())


def promotes_lossless(arrays: Sequence[np.ndarray]) -> bool:
    """True when concatenating these numeric arrays under numpy's common
    dtype loses no values.  The one guard the sorted-key paths (LSM merge
    take-indices, the dataset's live-row selection) share against silent
    key corruption: int64+float64 or int64+uint64 promote to float64,
    which rounds integers beyond 2**53."""
    if len({a.dtype for a in arrays}) <= 1:
        return True
    promo = np.result_type(*(a.dtype for a in arrays))
    return promo.kind in "biuf" and all(
        np.array_equal(a.astype(promo).astype(a.dtype), a) for a in arrays)


@dataclass
class Column:
    kind: str
    data: np.ndarray                    # physical values (codes for 'str')
    valid: np.ndarray                   # bool bitmap: field present?
    values: Optional[List[str]] = None  # sorted dictionary for 'str'
    # pow2-padded (data, valid) view, built once per immutable column
    _padded: Optional[tuple] = field(default=None, repr=False, compare=False)
    # int64 widening of padded() for bool columns, built once (stable
    # identity: the device buffer pool keys on the padded arrays)
    _padded_i64: Optional[tuple] = field(default=None, repr=False,
                                         compare=False)

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def padded(self) -> tuple:
        """``(data, valid)`` padded to the next power of two with invalid
        rows.  Columns are immutable, so the padded view is cached: kernel
        calls over the same component batch reuse one allocation, and the
        jitted cores see pow2 shapes only (no per-length retraces)."""
        n = len(self)
        np2 = pow2_len(n)
        if np2 == n:
            return self.data, self.valid
        if self._padded is None:
            pad = np2 - n
            if self.data.dtype == object:
                data = np.empty(np2, dtype=object)
                data[:n] = self.data
            else:
                data = np.concatenate(
                    [self.data, np.zeros(pad, dtype=self.data.dtype)])
            valid = np.concatenate([self.valid, np.zeros(pad, dtype=bool)])
            self._padded = (data, valid)
        return self._padded

    def padded_int64(self) -> tuple:
        """``padded()`` with the data widened to int64 — what the kernels
        compare bool columns as.  Cached so repeated queries hand the
        same arrays to the device pool instead of re-widening per call."""
        if self._padded_i64 is None:
            data, valid = self.padded()
            self._padded_i64 = (data.astype(np.int64), valid)
        return self._padded_i64

    def take(self, idx: np.ndarray) -> "Column":
        return Column(self.kind, self.data[idx], self.valid[idx], self.values)

    def decode(self) -> List[Any]:
        """Python values; MISSING where invalid."""
        if self.kind == "obj":
            out = list(self.data)
        elif self.kind == "str":
            # invalid rows carry code 0 even when the dictionary is empty
            # (all-missing column): only valid rows may index the dict
            vals = self.values or []
            nv = len(vals)
            out = [vals[c] if c < nv else None
                   for c in self.data.tolist()]
        elif self.kind in ("dt", "date"):
            out = [decode_scalar(x, self.kind) for x in self.data.tolist()]
        else:
            out = self.data.tolist()
        ok = self.valid
        return [v if ok[i] else MISSING for i, v in enumerate(out)]


def _empty_column(kind: str, n: int) -> Column:
    if kind == "obj":
        data = np.empty(n, dtype=object)
    else:
        data = np.zeros(n, dtype=_NP_DTYPE[kind])
    vals: Optional[List[str]] = [] if kind == "str" else None
    return Column(kind, data, np.zeros(n, dtype=bool), vals)


def build_column(raw: Sequence[Any], kind: str) -> Column:
    """Shred one field's values (MISSING marks absent) into a Column,
    downgrading to ``obj`` if any present value defies the kind."""
    n = len(raw)
    valid = np.fromiter((v is not MISSING for v in raw), dtype=bool, count=n)
    if kind == "obj":
        data = np.empty(n, dtype=object)
        for i, v in enumerate(raw):
            data[i] = None if v is MISSING else v
        return Column("obj", data, valid)
    try:
        if kind == "str":
            present = sorted({v for v in raw if v is not MISSING})
            if any(not isinstance(v, str) for v in present):
                raise TypeError("non-string in str column")
            code = {v: i for i, v in enumerate(present)}
            data = np.fromiter(
                (0 if v is MISSING else code[v] for v in raw),
                dtype=np.int32, count=n)
            return Column("str", data, valid, present)
        data = np.fromiter(
            (0 if v is MISSING else encode_scalar(v, kind) for v in raw),
            dtype=_NP_DTYPE[kind], count=n)
        return Column(kind, data, valid)
    except (TypeError, ValueError, OverflowError):
        return build_column(raw, "obj")


def _remap_dictionary(col: Column, merged: List[str]) -> Column:
    """Re-express a str column's codes against a larger sorted dictionary."""
    if col.values == merged:
        return col
    old = np.asarray(col.values if col.values else [""], dtype=object)
    lut = np.searchsorted(np.asarray(merged, dtype=object), old)
    data = lut[col.data].astype(np.int32) if len(col.values or []) \
        else np.zeros(len(col), dtype=np.int32)
    return Column("str", data, col.valid, merged)


@dataclass
class ColumnBatch:
    columns: Dict[str, Column] = field(default_factory=dict)
    length: int = 0

    # -- construction -------------------------------------------------------
    @classmethod
    def from_rows(cls, rows: Sequence[Dict[str, Any]],
                  schema: Optional[ColumnSchema] = None,
                  columns: Optional[Sequence[str]] = None) -> "ColumnBatch":
        """Shred row dicts.  Without a schema, kinds are inferred from the
        values (open-type friendly).  ``columns`` restricts shredding to a
        projection."""
        if schema is None:
            schema = ColumnSchema()
            for r in rows:
                for k, v in r.items():
                    schema.observe_value(k, v)
        names = list(columns) if columns is not None else list(schema)
        out: Dict[str, Column] = {}
        for name in names:
            if columns is not None and name not in schema:
                continue
            raw = [r.get(name, MISSING) for r in rows]
            out[name] = build_column(raw, schema.kind(name))
        return cls(out, len(rows))

    @classmethod
    def concat(cls, batches: Sequence["ColumnBatch"]) -> "ColumnBatch":
        batches = [b for b in batches]
        if not batches:
            return cls({}, 0)
        if len(batches) == 1:
            return batches[0]
        n = sum(b.length for b in batches)
        names: List[str] = []
        for b in batches:
            for k in b.columns:
                if k not in names:
                    names.append(k)
        out: Dict[str, Column] = {}
        for name in names:
            pieces = [b.columns.get(name) for b in batches]
            kinds = {p.kind for p in pieces if p is not None}
            if len(kinds) > 1:          # mixed representations: objectify
                decoded: List[Any] = []
                for b, p in zip(batches, pieces):
                    decoded.extend(p.decode() if p is not None
                                   else [MISSING] * b.length)
                out[name] = build_column(decoded, "obj")
                continue
            kind = kinds.pop()
            cols = [p if p is not None else _empty_column(kind, b.length)
                    for b, p in zip(batches, pieces)]
            if kind == "str":
                merged = sorted(set().union(*(c.values or [] for c in cols)))
                cols = [_remap_dictionary(c, merged) for c in cols]
                out[name] = Column(
                    "str", np.concatenate([c.data for c in cols]),
                    np.concatenate([c.valid for c in cols]), merged)
            else:
                out[name] = Column(
                    kind, np.concatenate([c.data for c in cols]),
                    np.concatenate([c.valid for c in cols]))
        return cls(out, n)

    # -- relational views ---------------------------------------------------
    def project(self, cols: Sequence[str]) -> "ColumnBatch":
        return ColumnBatch({c: self.columns[c] for c in cols
                            if c in self.columns}, self.length)

    def take(self, idx: np.ndarray) -> "ColumnBatch":
        return ColumnBatch({k: c.take(idx) for k, c in self.columns.items()},
                           int(len(idx)))

    def filter(self, mask: np.ndarray) -> "ColumnBatch":
        return self.take(np.nonzero(mask)[0])

    def slice(self, n: int) -> "ColumnBatch":
        return self.take(np.arange(min(n, self.length)))

    def with_column(self, name: str, col: Column) -> "ColumnBatch":
        cols = dict(self.columns)
        cols[name] = col
        return ColumnBatch(cols, self.length)

    def sort_by(self, keys: Sequence[str], desc: bool = False
                ) -> "ColumnBatch":
        """Rows reordered by the named columns (vectorized lexsort when
        every key column is dense and comparable; decoded fallback for
        ``obj`` keys or columns with absent values)."""
        n = self.length
        arrs = []
        vectorized = bool(keys)
        for k in keys:
            col = self.columns.get(k)
            if col is None or col.kind == "obj" or not col.valid.all():
                vectorized = False
                break
            a = col.data.astype(np.int64) if col.kind == "bool" else col.data
            arrs.append(-a if desc else a)
        if vectorized:
            order = np.lexsort(tuple(reversed(arrs)))
        elif n == 0:
            order = np.zeros(0, dtype=np.int64)
        else:
            rows = self.to_rows()
            # absent values sort first via the presence flag, so a
            # missing field is never compared against a real value
            order = np.asarray(
                sorted(range(n),
                       key=lambda i: tuple((k in rows[i], rows[i].get(k))
                                           for k in keys),
                       reverse=desc), dtype=np.int64)
        return self.take(order)

    @classmethod
    def merge_sorted(cls, batches: Sequence["ColumnBatch"],
                     key_arrays: Sequence[np.ndarray],
                     tombs: Optional[Sequence[np.ndarray]] = None,
                     *, drop_tombstones: bool = False
                     ) -> tuple:
        """Column-wise k-way merge of sorted runs (the LSM merge path).

        ``key_arrays[i]`` holds batch i's sorted, unique keys; batches are
        ordered newest -> oldest and the newest wins each duplicate key.
        The ``sorted_merge_take`` kernel computes take-indices once, then
        every column — string dictionaries included (``concat`` remaps
        codes onto the merged dictionary) — is gathered without
        materializing a single row.  Returns ``(batch, keys, tomb)``
        aligned with each other; see the kernel for tombstone semantics.
        """
        from ..kernels import columnar_ops as K
        keys, take, tomb = K.sorted_merge_take(
            key_arrays, tombs, drop_tombstones=drop_tombstones)
        merged = cls.concat(list(batches)).take(take)
        return merged, keys, tomb

    def row_at(self, i: int) -> Dict[str, Any]:
        """Reassemble one record without decoding the whole batch (the
        LSM point-lookup path over columnar components)."""
        r: Dict[str, Any] = {}
        for k, c in self.columns.items():
            if not c.valid[i]:
                continue
            if c.kind == "obj":
                r[k] = c.data[i]
            elif c.kind == "str":
                r[k] = (c.values or [])[int(c.data[i])]
            else:
                r[k] = decode_scalar(c.data[i], c.kind)
        return r

    # -- record reassembly --------------------------------------------------
    def to_rows(self) -> List[Dict[str, Any]]:
        """Reassemble record dicts; absent (invalid) fields are omitted."""
        decoded = {k: c.decode() for k, c in self.columns.items()}
        out: List[Dict[str, Any]] = []
        for i in range(self.length):
            r = {}
            for k, vals in decoded.items():
                v = vals[i]
                if v is not MISSING:
                    r[k] = v
            out.append(r)
        return out

    def schema(self) -> ColumnSchema:
        return ColumnSchema({k: c.kind for k, c in self.columns.items()})

    def __len__(self) -> int:
        return self.length
