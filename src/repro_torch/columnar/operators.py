"""Vectorized physical operators over ColumnBatches.

Each function mirrors the row-at-a-time semantics of one
``storage/query.py`` operator exactly (same aggregate null handling, same
partial/merge calculus, same hash-partition placement), but evaluates on
dense columns via ``kernels/columnar_ops``.  When a batch turns out not
to be vectorizable at runtime (``obj`` columns where the plan needs
comparisons — schema drift on open types), operators degrade to a
row-at-a-time pass over the decoded batch rather than failing: the
lowering decision was made before the data was seen.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels import columnar_ops as K
from .batch import Column, ColumnBatch, MISSING, build_column
from .schema import VECTOR_KINDS, decode_scalar, encode_scalar

__all__ = [
    "EMPTY", "make_range_preds", "select_batch", "select_batch_with_mask",
    "aggregate_batch", "fused_select_aggregate", "group_aggregate",
    "sort_batch",
    "join_batches", "partition_ids", "concat_gather",
    "candidate_position_mask", "index_post_validate",
]

EMPTY = object()          # make_range_preds: "no row can match"

_INT_LIKE = ("i64", "dt", "date", "bool")
_AGG_FNS = ("count", "sum", "min", "max", "avg")


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------

def _str_bounds(col: Column, lo: Any, hi: Any) -> Tuple[Any, Any]:
    """Translate string bounds into dictionary-code bounds (the dictionary
    is sorted, so code order == lexicographic order)."""
    vals = np.asarray(col.values or [], dtype=object)
    clo = None if lo is None else int(np.searchsorted(vals, lo, "left"))
    chi = None if hi is None else int(np.searchsorted(vals, hi, "right")) - 1
    return clo, chi


def make_range_preds(batch: ColumnBatch,
                     ranges: Dict[str, Tuple[Any, Any]]
                     ) -> Optional[List[K.Pred]]:
    """Compile sargable [lo, hi] bounds into kernel predicates.  Returns
    EMPTY when a referenced column is entirely absent, None when any
    column/literal cannot be evaluated vectorized."""
    preds: List[K.Pred] = []
    for fld, (lo, hi) in ranges.items():
        col = batch.columns.get(fld)
        if col is None:
            return EMPTY          # type: ignore[return-value]
        if col.kind not in VECTOR_KINDS:
            return None
        try:
            if col.kind == "str":
                if not (lo is None or isinstance(lo, str)) \
                        or not (hi is None or isinstance(hi, str)):
                    return None
                lo, hi = _str_bounds(col, lo, hi)
                if hi is not None and hi < 0:
                    return EMPTY  # type: ignore[return-value]
            else:
                lo = None if lo is None else encode_scalar(lo, col.kind)
                hi = None if hi is None else encode_scalar(hi, col.kind)
        except (TypeError, ValueError, OverflowError):
            return None
        # cached pow2 views: stable shapes AND stable identities (the
        # device buffer pool keys on these arrays)
        data, valid = col.padded_int64() if col.kind == "bool" \
            else col.padded()
        preds.append((data, valid, lo, hi))
    return preds


def select_batch(batch: ColumnBatch, ranges: Dict[str, Tuple[Any, Any]],
                 pred: Optional[Any], residual: bool) -> ColumnBatch:
    """STREAM_SELECT: vectorized range mask, then (unless the plan marked
    the ranges exact) the full row predicate re-checked on survivors."""
    n = len(batch)
    preds = make_range_preds(batch, ranges) if ranges else None
    if preds is EMPTY:
        return batch.take(np.zeros(0, dtype=np.int64))
    if preds is None:
        # not vectorizable here: decoded row-at-a-time pass
        keep = np.fromiter((bool(pred(r)) for r in batch.to_rows()),
                           dtype=bool, count=n)
        return batch.filter(keep)
    out = batch.filter(K.range_mask(preds, n))
    if residual and pred is not None:
        rows = out.to_rows()
        keep = np.fromiter((bool(pred(r)) for r in rows), dtype=bool,
                           count=len(rows))
        out = out.filter(keep)
    return out


def select_batch_with_mask(batch: ColumnBatch, mask: np.ndarray,
                           pred: Optional[Any], residual: bool
                           ) -> ColumnBatch:
    """:func:`select_batch`'s tail when the range mask was already
    computed elsewhere (the SPMD path batches all partitions' masks into
    one dispatch — ``runtime/spmd.batched_range_masks``)."""
    out = batch.filter(mask)
    if residual and pred is not None:
        rows = out.to_rows()
        keep = np.fromiter((bool(pred(r)) for r in rows), dtype=bool,
                           count=len(rows))
        out = out.filter(keep)
    return out


# ---------------------------------------------------------------------------
# index access: candidate PKs -> position bitmap
# ---------------------------------------------------------------------------

def candidate_position_mask(keys: np.ndarray, cands: np.ndarray
                            ) -> np.ndarray:
    """Position bitmap of a sorted candidate-PK array over a partition's
    sorted live-pk array (``storage.dataset.partition_pk_array``).  Numeric
    pk domains run the fused Pallas/jnp sorted-intersection kernel; object
    pks (strings, tuples) intersect via the numpy sorted merge, degrading
    to set membership when the key domain is not totally ordered.  Multi-
    index conjunctions AND these bitmaps together before any record is
    gathered or decoded."""
    n = int(len(keys))
    if n == 0 or len(cands) == 0:
        return np.zeros(n, dtype=bool)
    if keys.dtype != object and keys.dtype.kind in "biuf" \
            and cands.dtype != object and cands.dtype.kind in "biuf":
        return K.sorted_intersect_mask(keys, cands)
    try:
        return K._sorted_merge_mask(keys, cands)
    except TypeError:          # mixed / incomparable pk types
        cs = set(cands.tolist())
        return np.fromiter((k in cs for k in keys.tolist()),
                           dtype=bool, count=n)


def index_post_validate(batch: ColumnBatch, mask: np.ndarray,
                        ranges: Dict[str, Tuple[Any, Any]],
                        pred: Optional[Any], residual: bool,
                        fields: Sequence[str] = ()) -> ColumnBatch:
    """POST_VALIDATE_SELECT over a candidate position bitmap: the sargable
    ranges are re-checked vectorized on the *partition* batch (stable
    shapes, so the jitted mask kernel never retraces per query) and ANDed
    into the bitmap before the gather; the residual row predicate — or the
    whole predicate, for opaque (spatial/keyword) criteria and columns
    that degrade to ``obj`` — runs row-at-a-time on the gathered survivors
    only.  When the bitmap is sparse relative to the partition, the whole
    re-check runs row-at-a-time on the few gathered candidates instead
    (``ranges`` is implied by ``pred``, the select contract), dodging the
    whole-partition mask's dispatch floor on selective queries."""
    n = len(batch)
    found = int(mask.sum())
    need_pred = pred is not None and residual
    if ranges:
        if pred is not None and found * 8 < n:
            need_pred = True       # pred implies ranges (select contract)
        else:
            preds = make_range_preds(batch, ranges)
            if preds is EMPTY:
                return batch.take(np.zeros(0, dtype=np.int64))
            if preds is None:      # obj-degraded column: pred row-checks
                need_pred = pred is not None
            else:
                mask = mask & K.range_mask(preds, n)
    got = batch.filter(mask)
    if need_pred and len(got):
        # decode only the fields pred declares it reads (the select
        # contract R1 also relies on): survivors alone pay full decode
        view = got.project(list(fields)) if fields else got
        rows = view.to_rows()
        keep = np.fromiter((bool(pred(r)) for r in rows), dtype=bool,
                           count=len(rows))
        got = got.filter(keep)
    return got


# ---------------------------------------------------------------------------
# aggregation (matches storage/query._agg_row / _agg_merge exactly)
# ---------------------------------------------------------------------------

def _kernel_agg_cols(batch: ColumnBatch,
                     aggs: Dict[str, Tuple[str, str]]
                     ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]],
                                List[Tuple[str, str, str, Column]]]:
    """Columns the fused kernel can reduce: [(data, valid)], plus
    bookkeeping (name, fn, kind, col) aligned with them."""
    arrays, meta = [], []
    for name, (fn, cname) in aggs.items():
        if cname == "*":
            continue
        col = batch.columns.get(cname)
        if col is None or col.kind == "obj":
            continue
        if fn in ("sum", "avg") and col.kind not in ("i64", "f64", "bool"):
            continue
        # cached pow2 views: stable shapes and pool-stable identities
        data, valid = col.padded_int64() if col.kind == "bool" \
            else col.padded()
        arrays.append((data, valid))
        meta.append((name, fn, col.kind, col))
    return arrays, meta


def _decode_agg(v: Any, kind: str, col: Column) -> Any:
    if v is None:
        return None
    if kind == "str":
        return (col.values or [])[int(v)]
    if kind == "bool":
        return bool(v)
    return decode_scalar(v, kind)


def _py_agg_vals(batch: ColumnBatch, cname: str) -> List[Any]:
    col = batch.columns.get(cname)
    if col is None:
        return []
    return [v for v in col.decode() if v is not MISSING and v is not None]


def _finish_agg(out: Dict[str, Any], name: str, fn: str, partial: bool,
                cnt: int, s: Any, mn: Any, mx: Any) -> None:
    if fn == "count":
        out[name] = cnt
    elif fn == "sum":
        out[name] = s if cnt else 0
    elif fn == "min":
        out[name] = mn
    elif fn == "max":
        out[name] = mx
    elif fn == "avg":
        if partial:
            out[name + "__sum"] = s if cnt else 0
            out[name + "__cnt"] = cnt
        else:
            out[name] = (s / cnt) if cnt else None


def aggregate_batch(batch: ColumnBatch, aggs: Dict[str, Tuple[str, str]],
                    partial: bool,
                    ranges: Optional[Dict[str, Tuple[Any, Any]]] = None
                    ) -> Optional[Tuple[Dict[str, Any], int]]:
    """LOCAL_AGG (partial=True) / direct aggregation of one batch.  With
    ``ranges`` the predicate is fused into the same kernel pass (the
    filter+aggregate hot path); returns None if the fused predicate is
    not vectorizable (caller filters first, then retries without
    ranges).  Returns (aggregate row, predicate survivor count)."""
    n = len(batch)
    preds: List[K.Pred] = []
    if ranges:
        made = make_range_preds(batch, ranges)
        if made is None:
            return None
        preds = [] if made is EMPTY else made
        if made is EMPTY:
            n = 0
            batch = batch.take(np.zeros(0, dtype=np.int64))
    arrays, meta = _kernel_agg_cols(batch, aggs)
    res = K.fused_filter_aggregate(preds, arrays, n)

    def survivors() -> ColumnBatch:
        # non-vectorizable columns pay one mask gather, shared across them
        return batch.filter(K.range_mask(preds, len(batch))) if preds \
            else batch

    return _finish_aggregate(aggs, meta, res, partial, survivors)


def _finish_aggregate(aggs: Dict[str, Tuple[str, str]],
                      meta: List[Tuple[str, str, str, Column]],
                      res: Dict[str, Any], partial: bool,
                      survivors: Any) -> Tuple[Dict[str, Any], int]:
    """Decode one fused-reduction result into the aggregate row — the
    single decode shared by the kernel loop path (:func:`aggregate_batch`)
    and the stacked SPMD path (``runtime/spmd.batched_select_aggregate``),
    so the two are bit-identical by construction.  ``res`` is the
    ``fused_filter_aggregate`` dict; ``survivors`` lazily materializes
    the predicate-filtered batch for non-vectorizable columns (called at
    most once)."""
    total = res["count"]
    out: Dict[str, Any] = {}
    by_name = {m[0]: (i, m) for i, m in enumerate(meta)}
    got: Optional[ColumnBatch] = None
    for name, (fn, cname) in aggs.items():
        if fn == "count" and cname == "*":
            out[name] = total
            continue
        if name in by_name and by_name[name][1][1] == fn:
            i, (_, _, kind, col) = by_name[name]
            s = res["sums"][i]
            mn = _decode_agg(res["mins"][i], kind, col)
            mx = _decode_agg(res["maxs"][i], kind, col)
            if kind == "i64" and isinstance(s, float):
                s = int(s)      # TPU f32 path returns floats
            _finish_agg(out, name, fn, partial, res["cnts"][i], s, mn, mx)
            continue
        # non-vectorizable column (obj / exotic combo): decoded python pass,
        # computing only the reduction the agg fn asks for (min/max of
        # non-summable values must not touch sum, like the row engine)
        if got is None:
            got = survivors()
        vals = got.to_rows() if cname == "*" else _py_agg_vals(got, cname)
        reduce_sum = fn in ("sum", "avg") and vals and cname != "*"
        _finish_agg(out, name, fn, partial, len(vals),
                    sum(vals) if reduce_sum else 0,
                    min(vals) if (fn == "min" and vals and cname != "*")
                    else None,
                    max(vals) if (fn == "max" and vals and cname != "*")
                    else None)
    return out, total


def fused_select_aggregate(batch: ColumnBatch,
                           ranges: Dict[str, Tuple[Any, Any]],
                           aggs: Dict[str, Tuple[str, str]],
                           partial: bool
                           ) -> Optional[Tuple[Dict[str, Any], int]]:
    """STREAM_SELECT(exact ranges) + LOCAL_AGG fused into one kernel
    pass."""
    return aggregate_batch(batch, aggs, partial, ranges=ranges)


# ---------------------------------------------------------------------------
# grouped aggregation
# ---------------------------------------------------------------------------

def _encode_group_keys(batch: ColumnBatch, keys: Sequence[str]
                       ) -> Optional[List[np.ndarray]]:
    arrs = []
    for k in keys:
        col = batch.columns.get(k)
        if col is None or col.kind not in VECTOR_KINDS \
                or col.kind == "f64" or not col.valid.all():
            return None
        arrs.append(col.data.astype(np.int64))
    return arrs


def _group_ids(arrs: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    if len(arrs) == 1:
        uniq, inv = np.unique(arrs[0], return_inverse=True)
        return uniq.reshape(-1, 1), inv
    stack = np.stack(arrs, axis=1)
    uniq, inv = np.unique(stack, axis=0, return_inverse=True)
    return uniq, inv


def _group_sum(inv: np.ndarray, g: int, data: np.ndarray, ok: np.ndarray,
               int_exact: bool) -> np.ndarray:
    if int_exact:
        out = np.zeros(g, dtype=np.int64)
        np.add.at(out, inv[ok], data[ok])
        return out
    return np.bincount(inv[ok], weights=data[ok].astype(np.float64),
                       minlength=g)


def _group_minmax(inv: np.ndarray, g: int, data: np.ndarray,
                  ok: np.ndarray, is_min: bool) -> np.ndarray:
    if np.issubdtype(data.dtype, np.integer):
        ident = np.iinfo(data.dtype).max if is_min \
            else np.iinfo(data.dtype).min
    else:
        ident = np.inf if is_min else -np.inf
    out = np.full(g, ident, dtype=data.dtype)
    (np.minimum if is_min else np.maximum).at(out, inv[ok], data[ok])
    return out


def group_aggregate(batch: ColumnBatch, keys: Sequence[str],
                    aggs: Dict[str, Tuple[str, str]], mode: str
                    ) -> ColumnBatch:
    """LOCAL_PREAGG (mode='partial') / HASH_GROUP ('final') /
    GLOBAL_GROUP ('merge').  Merge consumes partial columns when present
    and falls back to raw aggregation otherwise, exactly like
    storage/query._agg_merge.  Aggregates over empty value sets surface
    as explicit nulls (the row engine emits ``name: None``), so
    downstream operators and the row boundary see them."""
    arrs = _encode_group_keys(batch, keys)
    if arrs is None:
        return _group_aggregate_rows(batch, keys, aggs, mode)
    uniq, inv = _group_ids(arrs)
    g = uniq.shape[0]
    n = len(batch)
    cols: Dict[str, Column] = {}
    allv = np.ones(g, dtype=bool)
    for j, k in enumerate(keys):
        src = batch.columns[k]
        data = uniq[:, j].astype(src.data.dtype)
        cols[k] = Column(src.kind, data, allv.copy(), src.values)

    def put(name: str, kind: str, data: np.ndarray, valid: np.ndarray,
            values: Optional[List[str]] = None) -> None:
        if valid.all():
            cols[name] = Column(kind, data, valid, values)
            return
        # empty-group aggregate: materialize the row engine's explicit
        # None (invalid would read as "field absent" downstream)
        dec = Column(kind, data, valid, values).decode()
        obj = np.empty(len(dec), dtype=object)
        for i2, v2 in enumerate(dec):
            obj[i2] = None if v2 is MISSING else v2
        cols[name] = Column("obj", obj, np.ones(len(dec), dtype=bool))

    for name, (fn, cname) in aggs.items():
        merge_partial = (mode == "merge"
                         and (name in batch.columns
                              or name + "__sum" in batch.columns))
        if merge_partial:
            if fn in ("count", "sum"):
                src = batch.columns[name]
                if src.kind not in ("i64", "f64"):
                    return _group_aggregate_rows(batch, keys, aggs, mode)
                data = _group_sum(inv, g, src.data, src.valid,
                                  src.kind == "i64")
                put(name, src.kind, data, allv.copy())
            elif fn in ("min", "max"):
                src = batch.columns[name]
                if src.kind not in VECTOR_KINDS:
                    return _group_aggregate_rows(batch, keys, aggs, mode)
                ok = src.valid
                cnt = np.bincount(inv[ok], minlength=g)
                data = _group_minmax(inv, g, src.data, ok, fn == "min")
                put(name, src.kind, data, cnt > 0, src.values)
            elif fn == "avg":
                ssrc = batch.columns[name + "__sum"]
                csrc = batch.columns[name + "__cnt"]
                if "obj" in (ssrc.kind, csrc.kind):
                    return _group_aggregate_rows(batch, keys, aggs, mode)
                s = _group_sum(inv, g, ssrc.data, ssrc.valid, False)
                c = _group_sum(inv, g, csrc.data, csrc.valid, True)
                data = np.divide(s, c, out=np.zeros(g), where=c > 0)
                put(name, "f64", data, c > 0)
            continue
        partial = (mode == "partial")
        if fn == "count" and cname == "*":
            put(name, "i64", np.bincount(inv, minlength=g).astype(np.int64),
                allv.copy())
            continue
        col = batch.columns.get(cname)
        if col is None:
            zero = np.zeros(g, dtype=np.int64)
            if fn == "count":
                put(name, "i64", zero, allv.copy())
            elif fn == "sum":
                put(name, "i64", zero, allv.copy())
            elif fn in ("min", "max"):
                put(name, "obj", np.empty(g, dtype=object),
                    np.zeros(g, dtype=bool))
            elif fn == "avg":
                if partial:
                    put(name + "__sum", "i64", zero, allv.copy())
                    put(name + "__cnt", "i64", zero.copy(), allv.copy())
                else:
                    put(name, "obj", np.empty(g, dtype=object),
                        np.zeros(g, dtype=bool))
            continue
        if col.kind == "obj" \
                or (fn in ("sum", "avg")
                    and col.kind not in ("i64", "f64", "bool")):
            return _group_aggregate_rows(batch, keys, aggs, mode)
        ok = col.valid
        cnt = np.bincount(inv[ok], minlength=g)
        if fn == "count":
            put(name, "i64", cnt.astype(np.int64), allv.copy())
            continue
        data = col.data.astype(np.int64) if col.kind == "bool" else col.data
        if fn in ("min", "max"):
            out = _group_minmax(inv, g, data, ok, fn == "min")
            put(name, col.kind, out.astype(col.data.dtype, copy=False),
                cnt > 0, col.values)
            continue
        s = _group_sum(inv, g, data, ok, col.kind != "f64")
        if fn == "sum":
            put(name, "f64" if col.kind == "f64" else "i64", s, allv.copy())
        elif fn == "avg":
            if partial:
                put(name + "__sum", "f64" if col.kind == "f64" else "i64",
                    s, allv.copy())
                put(name + "__cnt", "i64", cnt.astype(np.int64),
                    allv.copy())
            else:
                put(name, "f64",
                    np.divide(s.astype(np.float64), cnt,
                              out=np.zeros(g), where=cnt > 0), cnt > 0)
    return ColumnBatch(cols, g)


def _group_aggregate_rows(batch: ColumnBatch, keys: Sequence[str],
                          aggs: Dict[str, Tuple[str, str]], mode: str
                          ) -> ColumnBatch:
    """Decoded row-at-a-time fallback replicating the row engine's group
    operator (used when keys or aggregates are not vectorizable)."""
    from ..storage.query import _agg_merge, _agg_row
    groups: Dict[Tuple, List[Dict[str, Any]]] = {}
    for r in batch.to_rows():
        groups.setdefault(tuple(r[k] for k in keys), []).append(r)
    out_rows = []
    for gk, grows in groups.items():
        row = (_agg_merge(grows, aggs) if mode == "merge"
               else _agg_row(grows, aggs, partial=(mode == "partial")))
        row.update(dict(zip(keys, gk)))
        out_rows.append(row)
    return ColumnBatch.from_rows(out_rows)


# ---------------------------------------------------------------------------
# sort / top-k
# ---------------------------------------------------------------------------

def sort_batch(batch: ColumnBatch, keys: Sequence[str], desc: bool,
               limit: Optional[int] = None) -> ColumnBatch:
    n = len(batch)
    arrs = []
    vectorized = True
    for k in keys:
        col = batch.columns.get(k)
        if col is None or col.kind not in VECTOR_KINDS \
                or not col.valid.all():
            vectorized = False
            break
        a = col.data.astype(np.int64) if col.kind == "bool" else col.data
        arrs.append(-a if desc else a)   # negate: stable desc like sorted()
    if vectorized and keys:
        order = np.lexsort(tuple(reversed(arrs)))
    else:
        rows = batch.to_rows()
        order = np.asarray(sorted(range(n),
                                  key=lambda i: tuple(rows[i][k]
                                                      for k in keys),
                           reverse=desc), dtype=np.int64) \
            if n else np.zeros(0, dtype=np.int64)
    if limit is not None:
        order = order[:limit]
    return batch.take(order)


# ---------------------------------------------------------------------------
# hash join (int-domain keys; order-preserving on the probe side)
# ---------------------------------------------------------------------------

def _join_key_ids(lb: ColumnBatch, rb: ColumnBatch, lk: Sequence[str],
                  rk: Sequence[str]
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    larrs, rarrs = [], []
    for lkey, rkey in zip(lk, rk):
        lc, rc = lb.columns.get(lkey), rb.columns.get(rkey)
        if lc is None or rc is None or not lc.valid.all() \
                or not rc.valid.all():
            return None
        if lc.kind != rc.kind or lc.kind not in VECTOR_KINDS:
            return None
        if lc.kind == "str":
            merged = np.asarray(
                sorted(set(lc.values or []) | set(rc.values or [])),
                dtype=object)
            llut = np.searchsorted(
                merged, np.asarray(lc.values or ["\0"], dtype=object))
            rlut = np.searchsorted(
                merged, np.asarray(rc.values or ["\0"], dtype=object))
            la = llut[lc.data].astype(np.int64)
            ra = rlut[rc.data].astype(np.int64)
        elif lc.kind == "f64":
            both = np.concatenate([lc.data, rc.data])
            _, inv = np.unique(both, return_inverse=True)
            la, ra = inv[:len(lc)], inv[len(lc):]
        else:
            la = lc.data.astype(np.int64)
            ra = rc.data.astype(np.int64)
        larrs.append(la)
        rarrs.append(ra)
    if len(larrs) == 1:
        return larrs[0], rarrs[0]
    lstack = np.stack(larrs, axis=1)
    rstack = np.stack(rarrs, axis=1)
    both = np.concatenate([lstack, rstack], axis=0)
    _, inv = np.unique(both, axis=0, return_inverse=True)
    return inv[:len(lb)], inv[len(lb):]


def _merge_collision(lcol: Column, rcol: Column) -> Column:
    """{**r, **l} per-row: left wins where the left field is present."""
    if lcol.kind == rcol.kind and lcol.kind != "str":
        data = np.where(lcol.valid, lcol.data, rcol.data)
        return Column(lcol.kind, data, lcol.valid | rcol.valid)
    lvals, rvals = lcol.decode(), rcol.decode()
    merged = [lv if lv is not MISSING else rv
              for lv, rv in zip(lvals, rvals)]
    return build_column(merged, "obj")


def join_batches(lb: ColumnBatch, rb: ColumnBatch, lk: Sequence[str],
                 rk: Sequence[str]) -> ColumnBatch:
    """HYBRID_HASH_JOIN on one partition: build right, probe left, output
    rows ``{**right, **left}`` in probe order."""
    ids = _join_key_ids(lb, rb, lk, rk)
    if ids is None:
        return _join_rows(lb, rb, lk, rk)
    lids, rids = ids
    r_order = np.argsort(rids, kind="stable")
    rs = rids[r_order]
    lo = np.searchsorted(rs, lids, "left")
    hi = np.searchsorted(rs, lids, "right")
    counts = hi - lo
    total = int(counts.sum())
    l_idx = np.repeat(np.arange(len(lids)), counts)
    starts = np.repeat(lo, counts)
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                          counts)
    r_idx = r_order[starts + within]
    left_t = lb.take(l_idx)
    right_t = rb.take(r_idx)
    cols: Dict[str, Column] = dict(right_t.columns)
    for name, col in left_t.columns.items():
        cols[name] = (_merge_collision(col, cols[name])
                      if name in cols else col)
    return ColumnBatch(cols, total)


def _join_rows(lb: ColumnBatch, rb: ColumnBatch, lk: Sequence[str],
               rk: Sequence[str]) -> ColumnBatch:
    table: Dict[Tuple, List[Dict[str, Any]]] = {}
    for r in rb.to_rows():
        table.setdefault(tuple(r[k] for k in rk), []).append(r)
    out = []
    for l in lb.to_rows():
        for r in table.get(tuple(l[k] for k in lk), ()):
            out.append({**r, **l})
    return ColumnBatch.from_rows(out)


# ---------------------------------------------------------------------------
# hash repartitioning (placement-identical to storage/dataset)
# ---------------------------------------------------------------------------

def partition_ids(batch: ColumnBatch, keys: Sequence[str], p: int
                  ) -> np.ndarray:
    """Target partition per row; bit-for-bit identical to
    ``storage.dataset.hash_partition`` so columnar and row pipelines
    shuffle rows to the same places."""
    from ..storage.dataset import hash_partition, hash_partition_array
    if len(keys) == 1:
        col = batch.columns.get(keys[0])
        if col is not None and col.kind in ("i64", "bool") \
                and col.valid.all():
            return hash_partition_array(col.data, p)
        if col is not None and col.kind == "str" and col.valid.all():
            lut = np.asarray([hash_partition(v, p)
                              for v in (col.values or [])],
                             dtype=np.int64)
            return lut[col.data] if len(col.values or []) \
                else np.zeros(len(batch), dtype=np.int64)
    rows = batch.project(list(keys)).to_rows()
    return np.asarray(
        [hash_partition(tuple(r[k] for k in keys) if len(keys) > 1
                        else r[keys[0]], p) for r in rows],
        dtype=np.int64) if rows else np.zeros(0, dtype=np.int64)


def concat_gather(cparts: Sequence[ColumnBatch]) -> ColumnBatch:
    return ColumnBatch.concat([b for b in cparts if len(b)])
