"""Fused columnar predicate + reduction kernels (the columnar engine's
hot path), on PyTorch with hand-written CUDA kernels.

Four entry points, numpy in / python out, with the reference's
signatures (``repro/kernels/columnar_ops.py``):

  range_mask(preds, n)           K1: conjunctive [lo, hi] range predicate
                                 over K columns -> bool mask
  fused_filter_aggregate(...)    K2: the same mask fused with count / sum /
                                 min / max over M aggregate columns in one
                                 pass (no materialized mask, no gather)
  sorted_intersect_mask(...)     K3: sorted candidate keys vs a partition's
                                 sorted live keys -> position bitmap
  sorted_merge_take(...)         k-way sorted-PK merge/dedup/tombstone-drop
                                 -> take indices (K3 per component plus an
                                 exclusive cumsum: the LSM merge path)

Operands go through the device pool (``kernels/device_pool``) onto the
selected device (``kernels/ops.target``).  A CUDA operand launches the
kernel from ``csrc/`` (or raises); a CPU operand runs the kernel's plain
PyTorch version beside it.  The kernels compute in the column's own dtype
(int64, float64, int32 dictionary codes), so results equal the
reference's exact x64 path; the reference's f32 TPU operand stacking is
not carried over.  Operands keep the reference's pow2 padding, and
``trace_count()`` counts the first sighting of each (kernel, pow2 shape,
dtypes) triple — the port's stand-in for the reference's jit traces, so
repeated queries over pooled operands must not move it.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import device_pool as _pool
from . import ops as _ops
from ..obs import record_dispatch as _record_dispatch
from ..obs import record_retrace as _record_retrace
from ..columnar.batch import pow2_len as _pow2_len
from ..columnar.batch import promotes_lossless as _promotes_lossless

__all__ = ["range_mask", "fused_filter_aggregate", "sorted_intersect_mask",
           "sorted_merge_take", "trace_count", "range_mask_plain",
           "filter_aggregate_plain", "sorted_intersect_plain",
           "range_mask_cuda", "filter_aggregate_cuda", "decode_aggregate",
           "sorted_intersect_cuda", "fold_extra_preds", "bound_bits",
           "range_mask_rows_plain", "range_mask_rows_cuda"]

_TRACES = {"n": 0}
_SEEN: set = set()
_SEEN_LOCK = threading.Lock()


def trace_count() -> int:
    return _TRACES["n"]


def note_shape(kernel: str, *key: Any) -> bool:
    """Count the first sighting of a (kernel, pow2 shape, dtypes) key;
    True if it was one."""
    k = (kernel,) + key
    with _SEEN_LOCK:
        if k in _SEEN:
            return False
        _SEEN.add(k)
        _TRACES["n"] += 1
    _record_retrace()
    return True


# (data [N], valid [N] bool, lo, hi) — already in the column's physical
# (numeric) domain; None bound means unbounded on that side.
Pred = Tuple[np.ndarray, np.ndarray, Any, Any]

# device operand of one column: (data, valid, lo, hi) with 0-d numpy
# bounds in the data's dtype (None for aggregate columns)
Col = Tuple[torch.Tensor, torch.Tensor, Any, Any]

_KERNEL_DTYPES = (np.dtype(np.int64), np.dtype(np.float64),
                  np.dtype(np.int32))


def _prep_bounds(data: np.ndarray, lo: Any, hi: Any
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Same-dtype 0-d bound arrays (unbounded -> dtype extremes), exactly
    the reference's ``_prep_bounds``: a bound is cast to the column's
    dtype, so a float bound on an int column truncates as numpy does."""
    if np.issubdtype(data.dtype, np.integer):
        info = np.iinfo(data.dtype)
        return (np.asarray(info.min if lo is None else lo, data.dtype),
                np.asarray(info.max if hi is None else hi, data.dtype))
    return (np.asarray(-np.inf if lo is None else lo, data.dtype),
            np.asarray(np.inf if hi is None else hi, data.dtype))


def _kernel_array(arr: np.ndarray) -> np.ndarray:
    """Columns reach the kernels as int64, float64 or int32; anything
    else widens losslessly (bool / small ints -> int64, float32 ->
    float64).  The main path's columns already have a kernel dtype."""
    if arr.dtype in _KERNEL_DTYPES:
        return arr
    return arr.astype(np.float64 if arr.dtype.kind == "f" else np.int64)


def _pad_pred(p: Pred, np2: int) -> Pred:
    """Length-pad one predicate column to ``np2`` with invalid rows: the
    row-validity conjunct keeps padding out of the mask."""
    data, valid, lo, hi = p
    pad = np2 - data.shape[0]
    if pad <= 0:
        return p
    return (np.concatenate([data, np.zeros(pad, dtype=data.dtype)]),
            np.concatenate([valid, np.zeros(pad, dtype=bool)]), lo, hi)


@functools.lru_cache(maxsize=64)
def _live_pred(n: int, np2: int) -> Pred:
    """Unbounded predicate whose validity bitmap is the row-liveness flag
    (True for the first ``n`` rows): ANDing it in masks padding out.
    Memoized so repeated no-predicate aggregates hand the buffer pool the
    same arrays."""
    live = np.zeros(np2, dtype=bool)
    live[:n] = True
    return (np.zeros(np2, dtype=np.float64), live, None, None)


def _fetch_cols(preds: Sequence[Pred],
                aggs: Sequence[Tuple[np.ndarray, np.ndarray]] = ()
                ) -> Tuple[List[Col], List[Col], List[Any]]:
    """Pool-fetch predicate and aggregate columns; bounds are prepared in
    the column's own dtype before any widening."""
    host: List[np.ndarray] = []
    bounds = []
    for data, valid, lo, hi in preds:
        blo, bhi = _prep_bounds(data, lo, hi)
        data = _kernel_array(data)
        bounds.append((blo.astype(data.dtype), bhi.astype(data.dtype)))
        host += [data, valid]
    for data, valid in aggs:
        host += [_kernel_array(data), valid]
    ops, missed = _pool.fetch(host)
    k = len(preds)
    pcols = [(ops[2 * j], ops[2 * j + 1]) + bounds[j] for j in range(k)]
    acols = [(ops[2 * k + 2 * j], ops[2 * k + 2 * j + 1], None, None)
             for j in range(len(aggs))]
    return pcols, acols, missed


def _dtype_key(cols: Sequence[Col]) -> Tuple[str, ...]:
    return tuple(str(c[0].dtype) for c in cols)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the on-card yardstick)
# ---------------------------------------------------------------------------

def range_mask_plain(cols: Sequence[Col], n: int) -> torch.Tensor:
    """K1's plain version: bool [n] over ``n`` (padded) rows."""
    m = None
    for x, v, lo, hi in cols:
        mm = v & (x >= lo.item()) & (x <= hi.item())
        m = mm if m is None else (m & mm)
    return m


# float64 sums fold in the reference's order: XLA's CPU backend rewrites a
# sum over a pow2-padded vector into windows of 32 consecutive values,
# each summed left to right from 0.0, then the window sums the same way,
# level by level, until one value is left.  Padding adds +0.0 (a partial
# that starts at +0.0 never becomes -0.0), so the result is the complete
# 32-ary tree over the live values, whatever pow2 length they pad to.
SUM_WINDOW = 32


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a float64 vector in the window order above: one elementwise
    add a window position and level, so every device gives the same
    bits."""
    while True:
        pad = -x.shape[0] % SUM_WINDOW
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        w = x.view(-1, SUM_WINDOW)
        s = x.new_zeros(w.shape[0])
        for t in range(SUM_WINDOW):
            s = s + w[:, t]
        if s.shape[0] == 1:
            return s[0]
        x = s


# At a padded length of exactly 32 the reference's masked float64 sum takes
# another order.  There XLA:CPU emits each sum as its own fusion, a 32-trip
# loop of `fadd reassoc` over select(mask, x, 0.0), and LLVM's loop
# vectorizer reassociates it (dumped from jax 0.9.0: the fusions'
# ir-with-opt.ll): value i goes to accumulator (i / 4) mod U, lane i mod 4,
# in trip order; the accumulators fold as acc1 + acc0, then acc2 + that,
# then acc3 + that; the four lanes as (l0 + l2) + (l1 + l3).  The
# interleave U follows the loop body's size, so the number K of predicate
# columns the reference's jit sees (the live-row predicate counts as one).
# Found by a sweep of K = 0 .. 24 and n = 17, 24, 31, 32 against the
# reference (tests/test_torch_columnar_ops.py), the same for int64, int32
# and float64 predicates and any number of aggregate columns; K = 25 .. 64
# gave 4 too.  With no predicate (n = 32 exactly) and at every other
# length the order stays tree_sum's.
SUM32_UNROLL = {1: 4, 2: 4, 3: 2, 4: 2}       # K = 5 .. 15: 1; K >= 16: 4


def sum32_unroll(n: int, k: int) -> int:
    """The order of the reference's masked float64 sum over a padded length
    ``n`` under ``k`` predicate columns: U, the accumulators of the
    four-lane order above, at n = 32 and k >= 1; 0 for tree_sum's order."""
    if n != SUM_WINDOW or k <= 0:
        return 0
    return SUM32_UNROLL.get(k, 1 if k < 16 else 4)


def sum32(x: torch.Tensor, u: int) -> torch.Tensor:
    """Sum of a float64 [32] vector in the four-lane, ``u``-accumulator
    order above (each accumulator lane from +0.0: the reference's -0.0
    starts give the same bits, as its lane 0 starts at +0.0)."""
    trips = x.view(-1, u, 4)
    acc = x.new_zeros(u, 4)
    for t in range(trips.shape[0]):
        acc = acc + trips[t]
    v = acc[0]
    for a in range(1, u):
        v = acc[a] + v
    return (v[0] + v[2]) + (v[1] + v[3])


def masked_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """A float64 column's masked values summed as the reference sums them
    under ``k`` predicate columns (:func:`sum32_unroll`)."""
    u = sum32_unroll(x.shape[0], k)
    return sum32(x, u) if u else tree_sum(x)


def filter_aggregate_plain(pcols: Sequence[Col], acols: Sequence[Col],
                           n: int, dev: torch.device
                           ) -> Tuple[int, List[Tuple]]:
    """K2's plain version: (survivor count, [(sum, min, max, valid
    count)] per aggregate column); float64 sums in the reference's order
    under ``len(pcols)`` predicate columns (:func:`masked_sum`)."""
    if pcols:
        mask = range_mask_plain(pcols, n)
    else:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    total = int(mask.sum())
    per_col = []
    for x, v, _lo, _hi in acols:
        ok = mask & v
        cnt = int(ok.sum())
        if x.dtype.is_floating_point:
            zero, big, small = 0.0, float("inf"), float("-inf")
        else:
            x = x.to(torch.int64)
            info = torch.iinfo(torch.int64)
            zero, big, small = 0, info.max, info.min
        s = torch.where(ok, x, zero)
        s = (masked_sum(s, len(pcols)) if x.dtype.is_floating_point
             else s.sum()).item()
        mn = torch.where(ok, x, big).min().item()
        mx = torch.where(ok, x, small).max().item()
        per_col.append((s, mn, mx, cnt))
    return total, per_col


def sorted_intersect_plain(keys: torch.Tensor, n: int,
                           cands: torch.Tensor) -> torch.Tensor:
    """K3's plain version: lanes < n of ``keys`` found in sorted
    ``cands`` (same dtype), lanes >= n false."""
    m = cands.shape[0]
    pos = torch.searchsorted(cands, keys)
    hit = (pos < m) & (cands[pos.clamp(max=m - 1)] == keys)
    hit[n:] = False
    return hit


# ---------------------------------------------------------------------------
# CUDA launch glue (csrc/range_mask.cu, filter_aggregate.cu,
# sorted_intersect.cu); each wrapper counts its launches
# ---------------------------------------------------------------------------

class ColDesc(ctypes.Structure):
    """Mirror of ``struct ColDesc`` in csrc/common.cuh."""
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("lo_i", ctypes.c_int64), ("hi_i", ctypes.c_int64),
                ("lo_f", ctypes.c_double), ("hi_f", ctypes.c_double),
                ("dtype", ctypes.c_int32), ("pad_", ctypes.c_int32)]


_DT_TAG = {torch.int64: 0, torch.float64: 1, torch.int32: 2}
_MAX_COLS = 8                       # csrc/common.cuh MAX_COLS
# csrc/agg_kernel.cuh THREADS, RUN (rows a thread takes at a time),
# MAX_BLOCKS (the scratch's columns) and PART_SLOTS (its rows a stacked
# row: A6's 3 counts and 4 slots a column)
_AGG_THREADS, _AGG_RUN, _AGG_MAX_BLOCKS = 256, 8, 264
_PART_SLOTS = 3 + 4 * _MAX_COLS


def _descs(cols: Sequence[Col]) -> ctypes.Array:
    arr = (ColDesc * max(len(cols), 1))()
    for j, (x, v, lo, hi) in enumerate(cols):
        if not (x.is_cuda and v.is_cuda and v.dtype == torch.bool
                and x.is_contiguous() and v.is_contiguous()
                and x.dtype in _DT_TAG):
            raise TypeError(f"kernel operand {j}: contiguous CUDA "
                            f"int64/float64/int32 data with a bool "
                            f"validity bitmap expected, got {x.dtype} on "
                            f"{x.device}")
        d = arr[j]
        d.data, d.valid = x.data_ptr(), v.data_ptr()
        d.dtype = _DT_TAG[x.dtype]
        if lo is not None:
            if x.dtype == torch.float64:
                d.lo_f, d.hi_f = float(lo), float(hi)
            else:
                d.lo_i, d.hi_i = int(lo), int(hi)
    return arr


def _fn(name: str, argtypes: Sequence[Any]) -> Any:
    f = getattr(_ops.lib(), name)
    f.restype = ctypes.c_int
    f.argtypes = list(argtypes)
    return f


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def range_mask_cuda(cols: Sequence[Col], n: int) -> torch.Tensor:
    """K1 on the card: bool [n]."""
    out = torch.empty(n, dtype=torch.bool, device=cols[0][0].device)
    f = _fn("rt_range_mask", [_P, _I, _L, _P, _P])
    rc = f(ctypes.cast(_descs(cols), _P), len(cols), n, out.data_ptr(),
           _ops.stream(out))
    _ops.count(range_mask_cuda)
    _ops.check(rc, "range_mask")
    return out


range_mask_cuda.launches = 0


# a stacked predicate column (stacked K1 and K2, A6's validate ranges):
# (data [R, n], valid [R, n], lo [R], hi [R]) with numpy bounds in the
# data's dtype

def bound_bits(los: Sequence[np.ndarray], his: Sequence[np.ndarray]
               ) -> np.ndarray:
    """int64 [R, k, 2]: each row's lo / hi a predicate (k >= 1), integer
    bounds as int64 values and float64 bounds as their raw bits (the
    kernels' per-row bound layout)."""
    out = np.zeros((int(los[0].shape[0]), len(los), 2), dtype=np.int64)
    for j, (lo, hi) in enumerate(zip(los, his)):
        for e, b in enumerate((lo, hi)):
            b = np.ascontiguousarray(b)
            out[:, j, e] = b.view(np.int64) if b.dtype == np.float64 \
                else b.astype(np.int64)
    return out


def device_cols(cols: Sequence[Tuple]) -> List[Col]:
    """Stacked columns as kernel operands whose bounds go up apart."""
    return [(c[0], c[1], None, None) for c in cols]


def bounds_dev(pcols: Sequence[Tuple], dev: torch.device) -> torch.Tensor:
    bb = bound_bits([c[2] for c in pcols], [c[3] for c in pcols])
    return torch.from_numpy(bb).to(dev)


def range_mask_rows_plain(pcols: Sequence[Tuple], rows: int, n: int
                          ) -> torch.Tensor:
    """Stacked K1's plain version: bool [R, n]."""
    dev = pcols[0][0].device
    m = torch.ones((rows, n), dtype=torch.bool, device=dev)
    for x, v, lo, hi in pcols:
        lo_t = torch.from_numpy(np.asarray(lo)).to(dev)[:, None]
        hi_t = torch.from_numpy(np.asarray(hi)).to(dev)[:, None]
        m = m & v & (x >= lo_t) & (x <= hi_t)
    return m


def range_mask_rows_cuda(pcols: Sequence[Tuple], rows: int, n: int
                         ) -> torch.Tensor:
    """Stacked K1 on the card (K1 with a row axis, each row against its
    own bounds): one launch over every row (a pass per 8 predicates),
    bool [R, n]."""
    dev = pcols[0][0].device
    out = torch.empty((rows, n), dtype=torch.bool, device=dev)
    bounds = bounds_dev(pcols, dev)
    f = _fn("rt_range_mask_rows", [_P, _I, _L, _I, _P, _P, _P])
    rc = f(ctypes.cast(_descs(device_cols(pcols)), _P), len(pcols), n,
           rows, bounds.data_ptr(), out.data_ptr(), _ops.stream(out))
    _ops.count(range_mask_rows_cuda)
    _ops.check(rc, "range_mask (stacked)")
    return out


range_mask_rows_cuda.launches = 0


def agg_blocks(n: int) -> int:
    """Grid of K2's launch: a function of n only, so the fold order (and
    every float64 sum) is reproducible at a given n.  One run of 8 rows a
    thread, capped at two blocks an SM (threads then take several)."""
    return max(1, min(-(-n // (_AGG_RUN * _AGG_THREADS)), _AGG_MAX_BLOCKS))


def tree_node_stride(n: int) -> int:
    """K2's float64 node array a column: the ceil(n / 1024) sums of 1,024
    rows, then each upper level of ``tree_sum``'s order (a 32nd of the one
    below, rounded up)."""
    total = level = -(-n // SUM_WINDOW ** 2)
    while level > 1:
        level = -(-level // SUM_WINDOW)
        total += level
    return total


# per (device, stream): the partials [rows, PART_SLOTS, MAX_BLOCKS] of K2
# (and of its stacked form and A6's second pass, which run the same kernel
# with a row axis), a ticket a row, which the kernel leaves at 0, and the
# float64 node arrays [rows, MAX_COLS, node stride] (grown to the most
# rows and the largest n seen); launches on one stream run in order, and
# each kernel uses them within itself only, so they share them, whichever
# thread launches
_AGG_SCRATCH: Dict[Tuple[int, int], List[torch.Tensor]] = {}
# taken while a pool of per-stream scratch is looked up or grown
SCRATCH_LOCK = threading.Lock()


def _agg_scratch(dev: torch.device, stride: int, rows: int = 1
                 ) -> Tuple[torch.Tensor, ...]:
    key = _ops.stream_key(dev)
    with SCRATCH_LOCK:
        got = _AGG_SCRATCH.get(key)
        if got is None or got[1].numel() < rows:
            got = _AGG_SCRATCH[key] = [
                torch.empty((rows, _PART_SLOTS, _AGG_MAX_BLOCKS),
                            dtype=torch.int64, device=dev),
                torch.zeros(rows, dtype=torch.int32, device=dev),
                torch.empty(0 if got is None else got[2].numel(),
                            dtype=torch.float64, device=dev)]
        if got[2].numel() < rows * _MAX_COLS * stride:
            got[2] = torch.empty(rows * _MAX_COLS * stride,
                                 dtype=torch.float64, device=dev)
        return tuple(got)


def fold_extra_preds(pcols: Sequence[Col],
                     mask_fn: Callable[[Sequence[Col]], torch.Tensor]
                     ) -> List[Col]:
    """The predicate slots of K2 and A6's second pass for any number of
    predicate columns.  Their kernel takes ``MAX_COLS``; past that,
    ``mask_fn`` (K1, or stacked K1 for a row axis) ANDs predicates 7, 8,
    ... into one byte mask, which becomes slot 7's validity.  Slot 7 keeps
    column 7's data and bounds, so its bits are column 7's range AND that
    mask: exactly the conjunction of predicates 7, 8, ..., and with slots
    0-6 the conjunction of all.  Up to ``MAX_COLS`` columns nothing
    changes: no K1 launch, the same operands."""
    if len(pcols) <= _MAX_COLS:
        return list(pcols)
    head = _MAX_COLS - 1
    x, _v, lo, hi = pcols[head]
    return list(pcols[:head]) + [(x, mask_fn(pcols[head:]), lo, hi)]


def filter_aggregate_cuda(pcols: Sequence[Col], acols: Sequence[Col],
                          n: int, dev: torch.device) -> torch.Tensor:
    """K2 on the card: one launch per ``MAX_COLS`` aggregate columns, and
    one K1 launch first where there are more than ``MAX_COLS`` predicate
    columns (:func:`fold_extra_preds`).  Returns the raw int64 result row
    on the device: ``[count, (valid count, sum, min, max) per aggregate
    column]`` with float64 slots as raw bits (see
    :func:`decode_aggregate`), float64 sums folded in the reference's
    order (:func:`masked_sum` under ``len(pcols)`` columns).  Operands
    that are not all 16-byte aligned are read row by row."""
    u32 = sum32_unroll(n, len(pcols))
    pcols = fold_extra_preds(pcols, lambda cols: range_mask_cuda(cols, n))
    m = len(acols)
    pd, ad = _descs(pcols), _descs(acols)
    vec = all(c[0].data_ptr() % 16 == 0 and c[1].data_ptr() % 16 == 0
              for c in list(pcols) + list(acols))
    stride = tree_node_stride(n)
    part, ticket, nodes = _agg_scratch(dev, stride)
    out = torch.empty(1 + 4 * m, dtype=torch.int64, device=dev)
    f = _fn("rt_filter_aggregate",
            [_P, _I, _P, _I, _L, _I, _I, _P, _P, _P, _P, _L, _I, _P])
    rc = f(ctypes.cast(pd, _P), len(pcols), ctypes.cast(ad, _P), m, n,
           agg_blocks(n), int(vec), part.data_ptr(), ticket.data_ptr(),
           out.data_ptr(), nodes.data_ptr(), stride, u32, _ops.stream(out))
    _ops.count(filter_aggregate_cuda)
    _ops.check(rc, "fused_filter_aggregate")
    return out


filter_aggregate_cuda.launches = 0


def decode_aggregate(raw: np.ndarray, acols: Sequence[Col]
                     ) -> Tuple[int, List[Tuple]]:
    """K2's raw result row -> the plain version's (count, [(sum, min,
    max, valid count)]) with python ints / floats per column dtype."""
    rawf = raw.view(np.float64)
    per_col = []
    for j, (x, _v, _lo, _hi) in enumerate(acols):
        src = rawf if x.dtype == torch.float64 else raw
        conv = float if x.dtype == torch.float64 else int
        per_col.append((conv(src[2 + 4 * j]), conv(src[3 + 4 * j]),
                        conv(src[4 + 4 * j]), int(raw[1 + 4 * j])))
    return int(raw[0]), per_col


def sorted_intersect_cuda(keys: torch.Tensor, n: int,
                          cands: torch.Tensor) -> torch.Tensor:
    """K3 on the card: bool [len(keys)], lanes >= n false."""
    if not (keys.is_cuda and cands.is_cuda and keys.dtype == cands.dtype
            and keys.dtype in (torch.int64, torch.float64)
            and keys.is_contiguous() and cands.is_contiguous()):
        raise TypeError("sorted_intersect_cuda: contiguous CUDA int64 or "
                        "float64 keys and candidates of one dtype expected")
    out = torch.empty(keys.shape[0], dtype=torch.bool, device=keys.device)
    f = _fn("rt_sorted_intersect", [_P, _L, _P, _L, _I, _P, _L, _P])
    rc = f(keys.data_ptr(), n, cands.data_ptr(), cands.shape[0],
           int(keys.dtype == torch.float64), out.data_ptr(), out.shape[0],
           _ops.stream(out))
    _ops.count(sorted_intersect_cuda)
    _ops.check(rc, "sorted_intersect_mask")
    return out


sorted_intersect_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatching wrappers
# ---------------------------------------------------------------------------

def range_mask(preds: Sequence[Pred], n: int) -> np.ndarray:
    """Conjunctive range mask over K predicate columns -> bool [n]."""
    if n == 0:
        return np.zeros(0, dtype=bool)
    if not preds:
        return np.ones(n, dtype=bool)
    np2 = max(_pow2_len(n), max(int(p[0].shape[0]) for p in preds))
    pcols, _, missed = _fetch_cols([_pad_pred(p, np2) for p in preds])
    note_shape("range_mask", np2, _dtype_key(pcols))
    if pcols[0][0].is_cuda:
        out_t = range_mask_cuda(pcols, np2)
    else:
        out_t = range_mask_plain(pcols, np2)
    out = out_t.cpu().numpy()
    _record_dispatch("range_mask", h2d=missed, d2h=[out])
    return out[:n]


def fused_filter_aggregate(preds: Sequence[Pred],
                           aggs: Sequence[Tuple[np.ndarray, np.ndarray]],
                           n: int) -> Dict[str, Any]:
    """Filter + reduce in one pass.

    Returns ``{"count", "sums", "mins", "maxs", "cnts"}`` where ``count``
    is the number of mask survivors and per-aggregate lists are aligned
    with ``aggs`` (``cnts`` = valid survivors per column; ``mins``/
    ``maxs`` are None when that is 0).
    """
    if n == 0:
        return {"count": 0, "sums": [0] * len(aggs),
                "mins": [None] * len(aggs), "maxs": [None] * len(aggs),
                "cnts": [0] * len(aggs)}
    np2 = max([_pow2_len(n)] + [int(a[0].shape[0]) for a in aggs]
              + [int(p[0].shape[0]) for p in preds])
    if preds:                  # padded rows are invalid in every conjunct
        preds = [_pad_pred(p, np2) for p in preds]
    elif np2 != n:             # no predicate: mask out padding explicitly
        preds = [_live_pred(n, np2)]
    padded_aggs = []
    for data, valid in aggs:
        pad = np2 - data.shape[0]
        if pad > 0:
            data = np.concatenate([data, np.zeros(pad, dtype=data.dtype)])
            valid = np.concatenate([valid, np.zeros(pad, dtype=bool)])
        padded_aggs.append((data, valid))
    pcols, acols, missed = _fetch_cols(preds, padded_aggs)
    if note_shape("fused_filter_aggregate", np2, _dtype_key(pcols),
                  _dtype_key(acols)) and pcols:
        # the reference's aggregate core calls its mask core, a jit of its
        # own, which traces there where K1 has not seen the shape
        note_shape("range_mask", np2, _dtype_key(pcols))
    dev = _ops.target()
    if dev.type == "cuda":
        raw = filter_aggregate_cuda(pcols, acols, np2, dev).cpu().numpy()
        total, per_col = decode_aggregate(raw, acols)
        _record_dispatch("fused_filter_aggregate", h2d=missed, d2h=[raw])
    else:
        total, per_col = filter_aggregate_plain(pcols, acols, np2, dev)
        _record_dispatch("fused_filter_aggregate", h2d=missed)
    out: Dict[str, Any] = {"count": total, "sums": [], "mins": [],
                           "maxs": [], "cnts": []}
    for s, mn, mx, cnt in per_col:
        out["cnts"].append(cnt)
        out["sums"].append(s)
        out["mins"].append(mn if cnt else None)
        out["maxs"].append(mx if cnt else None)
    return out


def _sorted_merge_mask(keys: np.ndarray, cands: np.ndarray) -> np.ndarray:
    """Host (numpy) sorted merge: the object-dtype pk fallback in
    columnar/operators (no device kernel takes object keys)."""
    n = keys.shape[0]
    pos = np.searchsorted(keys, cands)
    posc = np.clip(pos, 0, n - 1)
    hit = (pos < n) & (keys[posc] == cands)
    mask = np.zeros(n, dtype=bool)
    mask[posc[hit]] = True
    return mask


def _promote(keys: np.ndarray, cands: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Both sides in their promoted dtype (int64 or float64), as the x64
    searchsorted compares them."""
    dt = np.result_type(keys.dtype, cands.dtype)
    if dt == np.uint64:
        raise TypeError("sorted_intersect_mask: uint64 keys have no exact "
                        "int64/float64 kernel dtype")
    dt = np.dtype(np.float64 if dt.kind == "f" else np.int64)
    return keys.astype(dt, copy=False), cands.astype(dt, copy=False)


def sorted_intersect_mask(keys: np.ndarray, cands: np.ndarray
                          ) -> np.ndarray:
    """Position bitmap of a sorted candidate-PK array over a partition's
    sorted live-pk array: ``mask[i] == (keys[i] in cands)``.  Empty
    inputs short-circuit (no zero-length kernel launch)."""
    n, m = int(keys.shape[0]), int(cands.shape[0])
    if n == 0 or m == 0:
        return np.zeros(n, dtype=bool)
    keys, cands = _promote(keys, cands)
    kp, cp = _pool.padded(keys, "edge"), _pool.padded(cands, "edge")
    ops, missed = _pool.fetch([kp, cp])
    note_shape("sorted_intersect_mask", kp.shape[0], cp.shape[0],
               str(kp.dtype))
    if ops[0].is_cuda:
        out_t = sorted_intersect_cuda(ops[0], n, ops[1])
    else:
        out_t = sorted_intersect_plain(ops[0], n, ops[1])
    out = out_t.cpu().numpy()
    _record_dispatch("sorted_intersect_mask", h2d=missed, d2h=[out])
    return out[:n]


# ---------------------------------------------------------------------------
# sorted k-way merge (columnar LSM merge path)
# ---------------------------------------------------------------------------

def _py_scalar_array(a: np.ndarray) -> np.ndarray:
    """Numeric array -> object array of python scalars, whose arbitrary-
    precision comparisons are exact across int/float domains."""
    out = np.empty(a.shape[0], dtype=object)
    for j, v in enumerate(a.tolist()):
        out[j] = v
    return out


def _merge_take_object(arrays: Sequence[np.ndarray],
                       offs: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Host merge for object-dtype keys (string / tuple pks): heapq merge
    of the per-component sorted runs; ties sort by component rank, so the
    first entry of each key group is the newest version."""
    def entries(i: int):
        a, off = arrays[i], offs[i]
        return ((a[j], i, off + j) for j in range(a.shape[0]))

    keys_l: List[Any] = []
    take_l: List[int] = []
    prev = sentinel = object()
    for key, _rank, pos in heapq.merge(
            *(entries(i) for i in range(len(arrays)) if arrays[i].shape[0])):
        if prev is sentinel or key != prev:
            keys_l.append(key)
            take_l.append(pos)
            prev = key
    out = np.empty(len(keys_l), dtype=object)
    for j, k in enumerate(keys_l):
        out[j] = k
    return out, np.asarray(take_l, dtype=np.int64)


def sorted_merge_take(key_arrays: Sequence[np.ndarray],
                      tombs: Optional[Sequence[np.ndarray]] = None,
                      *, drop_tombstones: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized k-way sorted-PK merge/dedup/tombstone-drop: the LSM
    merge kernel.

    ``key_arrays`` are per-component sorted, per-component-unique key
    arrays ordered newest -> oldest.  Returns ``(keys, take, tomb)``
    where ``keys`` is the sorted key union with the newest component
    winning each duplicate, ``take`` indexes the winning entries in the
    concatenation of ``key_arrays`` so every column of the merged output
    is a single gather, and ``tomb`` marks entries whose winner is a
    tombstone.  With ``drop_tombstones`` those entries are removed.

    Numeric keys take the reference's TPU-branch shape: K3 marks each
    component's keys in the sorted union, and because every component
    key appears in the union, an exclusive cumsum of that bitmap is the
    rank of union[j] within the component.  Object keys fall back to a
    host heapq merge.
    """
    arrays = [np.asarray(a) for a in key_arrays]
    lens = [int(a.shape[0]) for a in arrays]
    offs = [0] * len(arrays)
    for i in range(1, len(arrays)):
        offs[i] = offs[i - 1] + lens[i - 1]
    nonempty = [i for i, l in enumerate(lens) if l]
    if not nonempty:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=bool)
    # mixed dtypes promote on concat: require a lossless round-trip
    # into the promoted dtype or fall back to the exact object merge
    numeric = all(arrays[i].dtype != object
                  and arrays[i].dtype.kind in "biuf" for i in nonempty) \
        and _promotes_lossless([arrays[i] for i in nonempty])
    if numeric:
        union = np.unique(np.concatenate([arrays[i] for i in nonempty]))
        take = np.full(union.shape[0], -1, dtype=np.int64)
        for i in nonempty:                  # newest first: first hit wins
            mem = sorted_intersect_mask(union, arrays[i])
            pos = np.cumsum(mem) - mem      # exclusive cumsum == rank in c
            sel = (take < 0) & mem
            take[sel] = offs[i] + pos[sel]
    else:
        arrays = [a if a.dtype == object else _py_scalar_array(a)
                  for a in arrays]
        union, take = _merge_take_object(arrays, offs)
    if tombs is None:
        return union, take, np.zeros(take.shape[0], dtype=bool)
    tomb_all = np.concatenate(
        [np.asarray(t, dtype=bool) for t, l in zip(tombs, lens) if l]) \
        if any(lens) else np.zeros(0, dtype=bool)
    tomb = tomb_all[take]
    if drop_tombstones and tomb.any():
        keep = ~tomb
        union, take, tomb = union[keep], take[keep], tomb[keep]
    return union, take, tomb
