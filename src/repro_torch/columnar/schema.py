"""Column schema inference for ADM records (open *and* closed types).

A column *kind* names the physical representation of one field:

  i64   int64 values                     (ADM int32/int64)
  f64   float64 values                   (ADM float/double)
  bool  bool values
  dt    int64 microseconds since epoch   (ADM datetime objects)
  date  int64 days since epoch           (ADM date objects)
  str   int32 codes into a sorted per-batch dictionary (code order ==
        lexicographic order, so range predicates run on codes)
  obj   object array passthrough (points, nested records, lists/bags,
        mixed-type open fields, present-but-null values) — carried
        losslessly but never vectorized

Declared fields map straight from their ADMType; open (undeclared) fields
are inferred from observed values, with conflicting observations unifying
to ``obj``.  This mirrors how the columnar-LSM paper shreds schemaless
documents: the schema is whatever the data has shown so far.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core import adm

__all__ = ["ColumnSchema", "infer_kind", "unify_kinds", "kind_of_adm_type",
           "encode_scalar", "decode_scalar", "VECTOR_KINDS"]

# kinds whose physical representation is a comparable numeric array
VECTOR_KINDS = frozenset({"i64", "f64", "bool", "dt", "date", "str"})

_EPOCH_DT = _dt.datetime(1970, 1, 1)
_EPOCH_DATE = _dt.date(1970, 1, 1)

_ADM_KINDS = {
    "int32": "i64", "int64": "i64",
    "float": "f64", "double": "f64",
    "boolean": "bool",
    "datetime": "dt", "date": "date",
    "string": "str",
    "point": "obj",
}


def kind_of_adm_type(t: Any) -> str:
    """Physical column kind for a declared ADM field type."""
    if isinstance(t, adm.ADMType):
        return _ADM_KINDS.get(t.name, "obj")
    return "obj"   # nested records, lists, bags


def infer_kind(v: Any) -> str:
    """Kind of one observed (open-field) value.  ``None`` means
    present-but-null, which only ``obj`` can represent."""
    if v is None:
        return "obj"
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "i64" if -(2 ** 63) <= v < 2 ** 63 else "obj"
    if isinstance(v, (float, np.floating)):
        return "f64"
    if isinstance(v, str):
        return "str"
    if isinstance(v, _dt.datetime):
        return "dt" if v.tzinfo is None else "obj"
    if isinstance(v, _dt.date):
        return "date"
    return "obj"


def unify_kinds(a: Optional[str], b: Optional[str]) -> str:
    """Least common kind of two observations."""
    if a is None:
        return b or "obj"
    if b is None:
        return a
    if a == b:
        return a
    if {a, b} <= {"i64", "f64"}:
        return "f64"
    return "obj"


def encode_scalar(v: Any, kind: str) -> Any:
    """Encode one python value into the column's physical domain.  Raises
    (TypeError/ValueError/OverflowError) on mismatch — callers downgrade
    the column to ``obj``.  ``str`` kind returns the string itself (codes
    are per-batch; see batch.py)."""
    if kind == "i64":
        if isinstance(v, (bool, np.bool_)) \
                or not isinstance(v, (int, np.integer)):
            raise TypeError(f"not an int: {v!r}")
        if not -(2 ** 63) <= int(v) < 2 ** 63:
            raise OverflowError(v)
        return int(v)
    if kind == "f64":
        if isinstance(v, (bool, np.bool_)) \
                or not isinstance(v, (int, float, np.integer, np.floating)):
            raise TypeError(f"not a number: {v!r}")
        return float(v)
    if kind == "bool":
        if not isinstance(v, (bool, np.bool_)):
            raise TypeError(f"not a bool: {v!r}")
        return bool(v)
    if kind == "dt":
        if not isinstance(v, _dt.datetime) or v.tzinfo is not None:
            raise TypeError(f"not a naive datetime: {v!r}")
        delta = v - _EPOCH_DT
        return (delta.days * 86400 + delta.seconds) * 1_000_000 \
            + delta.microseconds
    if kind == "date":
        if isinstance(v, _dt.datetime) or not isinstance(v, _dt.date):
            raise TypeError(f"not a date: {v!r}")
        return (v - _EPOCH_DATE).days
    if kind == "str":
        if not isinstance(v, str):
            raise TypeError(f"not a string: {v!r}")
        return v
    return v   # obj: passthrough


def decode_scalar(x: Any, kind: str) -> Any:
    """Inverse of encode_scalar (exact round-trip)."""
    if kind == "i64":
        return int(x)
    if kind == "f64":
        return float(x)
    if kind == "bool":
        return bool(x)
    if kind == "dt":
        return _EPOCH_DT + _dt.timedelta(microseconds=int(x))
    if kind == "date":
        return _EPOCH_DATE + _dt.timedelta(days=int(x))
    return x


@dataclass
class ColumnSchema:
    """Ordered field-name -> kind mapping for a dataset or batch."""

    kinds: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_record_type(cls, rt: adm.RecordType) -> "ColumnSchema":
        return cls({f.name: kind_of_adm_type(f.type) for f in rt.fields})

    def observe_value(self, name: str, v: Any) -> None:
        """Fold one open-field observation into the schema."""
        self.kinds[name] = unify_kinds(self.kinds.get(name), infer_kind(v))

    def observe_row(self, row: Dict[str, Any], declared: Tuple[str, ...]
                    ) -> None:
        for k, v in row.items():
            if k not in declared:
                self.observe_value(k, v)

    def kind(self, name: str) -> str:
        return self.kinds.get(name, "obj")

    def union(self, other: "ColumnSchema") -> "ColumnSchema":
        out = dict(self.kinds)
        for k, v in other.kinds.items():
            out[k] = unify_kinds(out.get(k), v)
        return ColumnSchema(out)

    def copy(self) -> "ColumnSchema":
        return ColumnSchema(dict(self.kinds))

    def __contains__(self, name: str) -> bool:
        return name in self.kinds

    def __iter__(self):
        return iter(self.kinds)
