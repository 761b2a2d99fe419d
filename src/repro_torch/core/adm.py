"""ADM-style open/closed record types (paper §2.1).

AsterixDB's data model (ADM) lets a Datatype be *open* (instances may carry
extra, undeclared fields — stored inline per instance, costing bytes) or
*closed* (instances are validated to contain exactly the declared fields).
Table 2 of the paper shows the storage-size consequence: "Schema" (all fields
declared) vs "KeyOnly" (only the primary key declared) differ ~2x on disk.

We reproduce that faithfully: declared fields are encoded positionally with no
name bytes; open (undeclared) fields are encoded with their name inline.  The
same machinery doubles as the framework's config system: arch configs are
closed records (strict validation), experiment overlays are open records.
"""

from __future__ import annotations

import datetime as _dt
import struct
from dataclasses import dataclass, field as _dc_field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ADMType", "INT32", "INT64", "FLOAT", "DOUBLE", "STRING", "BOOLEAN",
    "DATETIME", "DATE", "POINT", "Field", "RecordType", "BagType",
    "OrderedListType", "ValidationError", "Dataverse",
]


class ValidationError(ValueError):
    """Raised when an instance does not conform to its Datatype."""


# ---------------------------------------------------------------------------
# Primitive types
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ADMType:
    """A primitive ADM type tag with an encoder/decoder."""

    name: str
    tag: int  # 1-byte wire tag

    def validate(self, v: Any) -> Any:
        if not _PRIM_OK[self.name](v):
            raise ValidationError(f"value {v!r} is not a valid {self.name}")
        if isinstance(v, int) and self.name in ("float", "double") \
                and not isinstance(v, bool):
            return float(v)     # ADM casts ints into float fields at
        return v                # ingest, so the stored value does not
        #                         depend on memtable-vs-component state

    def encode(self, v: Any, out: bytearray) -> None:
        if self.name == "int32":
            out += struct.pack("<i", v)
        elif self.name == "int64":
            out += struct.pack("<q", v)
        elif self.name == "float":
            out += struct.pack("<f", float(v))
        elif self.name == "double":
            out += struct.pack("<d", float(v))
        elif self.name == "boolean":
            out += b"\x01" if v else b"\x00"
        elif self.name == "string":
            b = v.encode("utf-8")
            _put_varint(out, len(b))
            out += b
        elif self.name in ("datetime", "date"):
            s = v.isoformat() if not isinstance(v, str) else v
            b = s.encode("utf-8")
            _put_varint(out, len(b))
            out += b
        elif self.name == "point":
            out += struct.pack("<dd", float(v[0]), float(v[1]))
        else:  # pragma: no cover
            raise TypeError(self.name)

    def decode(self, buf: memoryview, pos: int) -> Tuple[Any, int]:
        if self.name == "int32":
            return struct.unpack_from("<i", buf, pos)[0], pos + 4
        if self.name == "int64":
            return struct.unpack_from("<q", buf, pos)[0], pos + 8
        if self.name == "float":
            return struct.unpack_from("<f", buf, pos)[0], pos + 4
        if self.name == "double":
            return struct.unpack_from("<d", buf, pos)[0], pos + 8
        if self.name == "boolean":
            return bool(buf[pos]), pos + 1
        if self.name in ("string", "datetime", "date"):
            n, pos = _get_varint(buf, pos)
            return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
        if self.name == "point":
            x, y = struct.unpack_from("<dd", buf, pos)
            return (x, y), pos + 16
        raise TypeError(self.name)  # pragma: no cover


INT32 = ADMType("int32", 1)
INT64 = ADMType("int64", 2)
FLOAT = ADMType("float", 3)
DOUBLE = ADMType("double", 4)
STRING = ADMType("string", 5)
BOOLEAN = ADMType("boolean", 6)
DATETIME = ADMType("datetime", 7)
DATE = ADMType("date", 8)
POINT = ADMType("point", 9)

_PRIMS_BY_TAG = {t.tag: t for t in
                 (INT32, INT64, FLOAT, DOUBLE, STRING, BOOLEAN, DATETIME, DATE, POINT)}


def _put_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _get_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


# ---------------------------------------------------------------------------
# Composite types
# ---------------------------------------------------------------------------

# per-primitive validity predicates, hoisted out of ADMType.validate (the
# ingestion hot path calls it once per field per record)
_PRIM_OK = {
    "int32": lambda x: isinstance(x, int) and -(2**31) <= x < 2**31,
    # int64 range-checks at validation like int32 does: encode() packs
    # "<q" and would reject later anyway, but batch ingestion stores
    # columns without encoding, so both DML paths must gate here
    "int64": lambda x: isinstance(x, int) and -(2**63) <= x < 2**63,
    "float": lambda x: isinstance(x, (int, float)),
    "double": lambda x: isinstance(x, (int, float)),
    "string": lambda x: isinstance(x, str),
    "boolean": lambda x: isinstance(x, bool),
    "datetime": lambda x: isinstance(x, (_dt.datetime, str)),
    "date": lambda x: isinstance(x, (_dt.date, str)),
    # coords must be numeric here, not just at encode time: batch
    # ingestion stores columns without encoding, so validation is the
    # only gate both DML paths share
    "point": lambda x: (isinstance(x, (tuple, list)) and len(x) == 2
                        and all(isinstance(c, (int, float))
                                and not isinstance(c, bool) for c in x)),
}


@dataclass(frozen=True)
class OrderedListType:
    """ADM ordered list: ``[ItemType]``."""

    item: Any  # ADMType | RecordType | ...
    tag: int = 20

    def validate(self, v: Any) -> Any:
        if not isinstance(v, (list, tuple)):
            raise ValidationError(f"{v!r} is not an ordered list")
        return [self.item.validate(x) for x in v]

    def encode(self, v: Any, out: bytearray) -> None:
        _put_varint(out, len(v))
        for x in v:
            self.item.encode(x, out)

    def decode(self, buf: memoryview, pos: int) -> Tuple[Any, int]:
        n, pos = _get_varint(buf, pos)
        items = []
        for _ in range(n):
            x, pos = self.item.decode(buf, pos)
            items.append(x)
        return items, pos


@dataclass(frozen=True)
class BagType:
    """ADM bag (unordered list): ``{{ ItemType }}``. Stored canonically sorted
    where items are orderable so that bag equality is structural."""

    item: Any
    tag: int = 21

    def validate(self, v: Any) -> Any:
        if not isinstance(v, (list, tuple, set, frozenset)):
            raise ValidationError(f"{v!r} is not a bag")
        items = [self.item.validate(x) for x in v]
        try:
            return sorted(items)
        except TypeError:
            return list(items)

    encode = OrderedListType.encode
    decode = OrderedListType.decode


@dataclass(frozen=True)
class Field:
    name: str
    type: Any
    optional: bool = False  # the ADM ``?`` suffix
    default: Any = None


# Tag used when encoding an *undeclared* (open) field's value: we need a type
# tag per value since there is no schema to drive decoding.
def _encode_any(v: Any, out: bytearray) -> None:
    if isinstance(v, bool):
        out.append(BOOLEAN.tag); BOOLEAN.encode(v, out)
    elif isinstance(v, _dt.datetime):
        out.append(DATETIME.tag); DATETIME.encode(v, out)
    elif isinstance(v, _dt.date):
        out.append(DATE.tag); DATE.encode(v, out)
    elif isinstance(v, int):
        out.append(INT64.tag); INT64.encode(v, out)
    elif isinstance(v, float):
        out.append(DOUBLE.tag); DOUBLE.encode(v, out)
    elif isinstance(v, str):
        out.append(STRING.tag); STRING.encode(v, out)
    elif isinstance(v, (list, tuple)):
        out.append(20); _put_varint(out, len(v))
        for x in v:
            _encode_any(x, out)
    elif isinstance(v, dict):
        out.append(30); _put_varint(out, len(v))
        for k in sorted(v):
            STRING.encode(k, out)
            _encode_any(v[k], out)
    elif v is None:
        out.append(0)
    else:
        raise ValidationError(f"cannot encode open value {v!r}")


def _decode_any(buf: memoryview, pos: int) -> Tuple[Any, int]:
    tag = buf[pos]; pos += 1
    if tag == 0:
        return None, pos
    if tag in _PRIMS_BY_TAG:
        return _PRIMS_BY_TAG[tag].decode(buf, pos)
    if tag == 20:
        n, pos = _get_varint(buf, pos)
        items = []
        for _ in range(n):
            x, pos = _decode_any(buf, pos)
            items.append(x)
        return items, pos
    if tag == 30:
        n, pos = _get_varint(buf, pos)
        d = {}
        for _ in range(n):
            k, pos = STRING.decode(buf, pos)
            d[k], pos = _decode_any(buf, pos)
        return d, pos
    raise ValidationError(f"bad open-value tag {tag}")


@dataclass(frozen=True)
class RecordType:
    """ADM record type.  ``open=True`` (the AsterixDB default) permits
    instance-level extra fields; ``open=False`` (``closed``) forbids them."""

    name: str
    fields: Tuple[Field, ...]
    open: bool = True  # AsterixDB datatypes are open by default
    tag: int = 31

    def __post_init__(self):
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValidationError(f"duplicate field names in {self.name}")
        # frozen dataclass: sneak the cache in (fields are immutable, so
        # the map is too); validate/encode hit it once per record
        object.__setattr__(self, "_field_map",
                           {f.name: f for f in self.fields})

    @property
    def field_map(self) -> Dict[str, Field]:
        return self._field_map

    def validate(self, v: Any) -> Dict[str, Any]:
        if not isinstance(v, dict):
            raise ValidationError(f"{v!r} is not a record")
        out: Dict[str, Any] = {}
        fmap = self.field_map
        for f in self.fields:
            if f.name in v and v[f.name] is not None:
                out[f.name] = f.type.validate(v[f.name])
            elif f.optional:
                if f.default is not None:
                    out[f.name] = f.default
            else:
                raise ValidationError(
                    f"record of type {self.name} missing required field {f.name!r}")
        extras = {k: x for k, x in v.items() if k not in fmap}
        if extras:
            if not self.open:
                raise ValidationError(
                    f"closed type {self.name} forbids extra fields {sorted(extras)}")
            out.update(extras)
        return out

    # -- wire format ------------------------------------------------------
    def encode(self, v: Dict[str, Any], out: Optional[bytearray] = None) -> bytes:
        """Declared fields: positional, no name bytes.  Optional declared
        fields: 1-byte presence flag.  Open fields: (name, tagged value)."""
        buf = bytearray() if out is None else out
        fmap = self.field_map
        for f in self.fields:
            if f.optional:
                present = f.name in v
                buf.append(1 if present else 0)
                if present:
                    f.type.encode(v[f.name], buf)
            else:
                f.type.encode(v[f.name], buf)
        extras = sorted(k for k in v if k not in fmap)
        _put_varint(buf, len(extras))
        for k in extras:
            STRING.encode(k, buf)
            _encode_any(v[k], buf)
        return bytes(buf) if out is None else b""

    def decode(self, data: Any, pos: int = 0) -> Tuple[Dict[str, Any], int]:
        buf = memoryview(data) if not isinstance(data, memoryview) else data
        out: Dict[str, Any] = {}
        for f in self.fields:
            if f.optional:
                present = buf[pos]; pos += 1
                if not present:
                    continue
            out[f.name], pos = f.type.decode(buf, pos)
        n, pos = _get_varint(buf, pos)
        for _ in range(n):
            k, pos = STRING.decode(buf, pos)
            out[k], pos = _decode_any(buf, pos)
        return out, pos

    def encoded_size(self, v: Dict[str, Any]) -> int:
        return len(self.encode(self.validate(v)))

    # -- schema surgery (the Table-2 experiment) ---------------------------
    def key_only(self, *key_fields: str) -> "RecordType":
        """The paper's *KeyOnly* variant: declare only the primary key; every
        other field becomes an instance-level open field."""
        keep = tuple(f for f in self.fields if f.name in key_fields)
        missing = set(key_fields) - {f.name for f in keep}
        if missing:
            raise ValidationError(f"unknown key fields {sorted(missing)}")
        return RecordType(self.name + "_KeyOnly", keep, open=True)

    def closed(self) -> "RecordType":
        return RecordType(self.name, self.fields, open=False)


# ---------------------------------------------------------------------------
# Dataverse: the top-level namespace (paper §2.1)
# ---------------------------------------------------------------------------

@dataclass
class Dataverse:
    """A namespace of types + datasets; the system catalog is itself stored as
    data ("eats its own dog food", paper §3 Query 1)."""

    name: str
    types: Dict[str, RecordType] = _dc_field(default_factory=dict)
    datasets: Dict[str, Any] = _dc_field(default_factory=dict)

    def create_type(self, rt: RecordType) -> RecordType:
        if rt.name in self.types:
            raise ValidationError(f"type {rt.name} already exists in {self.name}")
        self.types[rt.name] = rt
        return rt

    def create_dataset(self, name: str, dataset: Any) -> Any:
        if name in self.datasets:
            raise ValidationError(f"dataset {name} already exists in {self.name}")
        self.datasets[name] = dataset
        return dataset

    def catalog_records(self) -> List[Dict[str, Any]]:
        """Metadata-as-data: one record per dataset (cf. Query 1)."""
        recs = []
        for dname, ds in self.datasets.items():
            recs.append({
                "dataverse": self.name,
                "dataset": dname,
                "datatype": getattr(getattr(ds, "dtype", None), "name", "?"),
                "primary_key": list(getattr(ds, "primary_key", ()) or ()),
                "num_partitions": getattr(ds, "num_partitions", 1),
            })
        return recs
