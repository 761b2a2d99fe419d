"""Mesh-parallel partition runtime (rung 4): one dispatch for all
partitions instead of a python loop over them.

The reference (``repro/runtime/spmd.py``) stacks every partition's
pow2-padded operands along a leading partition axis and runs one
``shard_map`` over a jax mesh of devices.  The port has one card, so its
mesh is a :class:`PartitionMesh`: ``n`` logical partition lanes on
``kernels.ops.target()``.  Inside ``with use_partition_mesh(n):`` (or
``run_query(..., mesh=n)``) the executor's eligible per-partition loops
run as one launch over the stacked rows:

  index chains         A6 over every partition row (``run_chain_stack``,
                       ``columnar/plancache``'s ``run_all``)
  select masks         stacked K1 (:func:`batched_range_masks`)
  fused aggregates     stacked K2 (:func:`batched_select_aggregate`)
  hash repartitions    the exchange: the sources' rows partitioned on
                       the card (:func:`exchange_batches`, lanes ==
                       partitions)
  partial-agg merges   a reduction over the stacked rows
                       (:func:`psum_merge`, :func:`pmin_merge`,
                       :func:`pmax_merge`)

The operands are stacked as the reference stacks them (:class:`StackCache`
keeps the stacked array identity-stable, so the device pool keeps it
resident and a warm query ships nothing), rows padded to a multiple of the
lanes (:func:`rows_for`), and results are bit-identical to the loop's.
``mesh=n`` means ``n`` lanes on the one card, so any ``n >= 1`` is
accepted; with no active mesh every consumer keeps the python loop.

Metrics (the reference's names, docs/METRICS.md section "mesh"):

  mesh.devices                  gauge: lanes of the active mesh (0 when
                                none is active)
  mesh.spmd_dispatches          counter: stacked dispatches
  mesh.spmd_partitions          counter: partitions covered by them
  mesh.spmd_fallbacks           counter: eligible calls that fell back to
                                the python loop (operand drift)
  mesh.exchange_rows            counter: rows moved by the exchange
  mesh.exchange_host_pids       counter: exchanges whose partition ids the
                                host computed (a key other than one int64
                                or bool column with every row valid)
  mesh.shard<k>.h2d_bytes       counter: lane k's share of stacked uploads
  mesh.partitions_per_dispatch  histogram: stacked partitions a dispatch
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..kernels import chain_ops as _chain
from ..kernels import device_pool as _pool
from ..kernels import spmd_ops as _ops
from ..kernels.columnar_ops import note_shape
from ..kernels.ops import target
from ..obs import record_dispatch as _record_dispatch

__all__ = [
    "PART_AXIS", "PartitionMesh", "partition_mesh", "use_partition_mesh",
    "active_mesh", "mesh_key", "mesh_size", "dispatch_totals", "rows_for",
    "note_fallback", "StackCache", "stack_cache", "fetch_sharded",
    "run_chain_stack", "batched_range_masks", "batched_select_aggregate",
    "exchange_batches", "psum_merge", "pmin_merge", "pmax_merge",
]

PART_AXIS = "part"

_DEVICES = obs.gauge("mesh.devices")
_DISPATCHES = obs.counter("mesh.spmd_dispatches")
_PARTITIONS = obs.counter("mesh.spmd_partitions")
_FALLBACKS = obs.counter("mesh.spmd_fallbacks")
_EXCH_ROWS = obs.counter("mesh.exchange_rows")
_HOST_PIDS = obs.counter("mesh.exchange_host_pids")
_PART_HIST = obs.histogram("mesh.partitions_per_dispatch")


# ---------------------------------------------------------------------------
# partition mesh context
# ---------------------------------------------------------------------------

class PartitionMesh:
    """``lanes`` logical partition lanes on one torch device (the
    reference's jax mesh of devices along ``PART_AXIS``)."""

    def __init__(self, lanes: int, device: Any) -> None:
        self.lanes = int(lanes)
        self.device = device

    def _key(self) -> Tuple:
        return (self.lanes, str(self.device))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, PartitionMesh) and \
            self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"PartitionMesh(lanes={self.lanes}, device={self.device})"


_ACTIVE: List[PartitionMesh] = []


def partition_mesh(lanes: Optional[int] = None) -> PartitionMesh:
    """A mesh of ``lanes`` partition lanes (default 1) on the selected
    device; raises where the device does (no card and "cuda" chosen)."""
    n = 1 if lanes is None else int(lanes)
    if n < 1:
        raise ValueError(f"a partition mesh needs at least one lane, "
                         f"not {n}")
    return PartitionMesh(n, target())


@contextlib.contextmanager
def use_partition_mesh(lanes: Optional[int] = None,
                       mesh: Optional[PartitionMesh] = None):
    """Activate a partition mesh for the executor's stacked paths; outside
    it the python loop is the unconditional path."""
    m = mesh if mesh is not None else partition_mesh(lanes)
    if not isinstance(m, PartitionMesh):
        raise TypeError(f"a PartitionMesh or a lane count expected, got "
                        f"{type(m).__name__}")
    _ACTIVE.append(m)
    _DEVICES.set(m.lanes)
    try:
        yield m
    finally:
        _ACTIVE.pop()
        _DEVICES.set(_ACTIVE[-1].lanes if _ACTIVE else 0)


def active_mesh() -> Optional[PartitionMesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def mesh_key(mesh: Optional[PartitionMesh] = None) -> Optional[Tuple]:
    """Hashable mesh signature for plan-cache keys: the loop and meshes of
    different lane counts are distinct entries."""
    m = mesh if mesh is not None else active_mesh()
    if m is None:
        return None
    return (PART_AXIS, m.lanes, str(m.device))


def mesh_size() -> int:
    m = active_mesh()
    return m.lanes if m is not None else 0


def dispatch_totals() -> Tuple[int, int]:
    """(stacked dispatches, partitions covered) — ExecStats diffs these per
    query, mirroring ``obs.kernel_totals``."""
    return (_DISPATCHES.value, _PARTITIONS.value)


def rows_for(n_real: int, mesh: PartitionMesh) -> int:
    """Stack row count: partitions padded up to a multiple of the lanes
    (the reference's even shard split)."""
    d = mesh.lanes
    return max(-(-n_real // d) * d, d)


def note_fallback() -> None:
    """Count one eligible call that fell back to the python loop
    (cross-partition operand drift)."""
    _FALLBACKS.inc()


def _note_spmd(mesh: PartitionMesh, n_parts: int) -> None:
    _DISPATCHES.inc()
    _PARTITIONS.inc(n_parts)
    _PART_HIST.observe(n_parts)


# ---------------------------------------------------------------------------
# stacked-operand cache (identity-stable, so the device pool can keep the
# stacked upload resident across queries: warm mesh queries h2d == 0)
# ---------------------------------------------------------------------------

class StackCache:
    """Memoized stacking of per-partition pow2-padded operands along a
    leading partition axis.  Keyed by the identity of every input array
    plus the output geometry, guarded by weak references (any input dying
    drops the entry, and the stacked array's own death evicts its device
    copy through the pool's finalizer).  Entries are capped FIFO as a leak
    backstop."""

    def __init__(self, max_entries: int = 4096) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[Tuple, Tuple[Tuple, np.ndarray, List]] = {}
        self._max = max_entries

    def stack(self, arrs: Sequence[Optional[np.ndarray]], rows: int,
              width: int, dtype: Any, fill: Any = 0) -> np.ndarray:
        """``[rows, width]`` array whose row ``i`` is ``arrs[i]`` (zero-
        padded to ``width``); ``None`` inputs and rows past ``len(arrs)``
        are ``fill``-rows (their lanes must be masked out by the caller's
        validity / liveness conjuncts)."""
        key = (tuple(0 if a is None else id(a) for a in arrs),
               rows, width, np.dtype(dtype).str, repr(fill))
        with self._lock:
            e = self._entries.get(key)
            if e is not None and all(
                    r() is a for r, a in zip(e[0], arrs) if r is not None):
                return e[1]
        out = np.full((rows, width), fill, dtype=dtype)
        for i, a in enumerate(arrs):
            if a is not None and a.shape[0]:
                out[i, :a.shape[0]] = a
        refs = tuple(None if a is None else weakref.ref(a) for a in arrs)
        fins = []
        for a in arrs:
            if a is not None:
                fin = weakref.finalize(a, self._drop, key)
                fin.atexit = False
                fins.append(fin)
        with self._lock:
            if len(self._entries) >= self._max:
                oldest = next(iter(self._entries))
                self._drop_locked(oldest)
            self._entries[key] = (refs, out, fins)
        return out

    def _drop(self, key: Tuple) -> None:
        with self._lock:
            self._drop_locked(key)

    def _drop_locked(self, key: Tuple) -> None:
        e = self._entries.pop(key, None)
        if e is not None:
            for fin in e[2]:
                fin.detach()

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            for key in list(self._entries):
                self._drop_locked(key)
            return n

    def entry_count(self) -> int:
        return len(self._entries)


stack_cache = StackCache()


def fetch_sharded(arrs: Sequence[Any], mesh: PartitionMesh
                  ) -> Tuple[List[Any], List[Any]]:
    """Pool-fetch stacked operands onto the mesh's device.  First touch
    uploads and is attributed per lane (``mesh.shard<k>.h2d_bytes``) on
    top of the usual kernel h2d accounting; later touches are pool hits,
    so a warm mesh query ships nothing."""
    ops, missed = _pool.fetch(arrs)
    if missed:
        d = mesh.lanes
        for a in missed:
            per = int(a.nbytes) // d
            for k in range(d):
                obs.counter(f"mesh.shard{k}.h2d_bytes").inc(per)
    return ops, missed


def _dt(arrs: Sequence[Any]) -> Tuple[str, ...]:
    return tuple(str(a.dtype) for a in arrs)


# ---------------------------------------------------------------------------
# the stacked index chain (A6 over every partition row)
# ---------------------------------------------------------------------------

def run_chain_stack(mesh: PartitionMesh, tiers, bounds, idx_pad, n_live,
                    preds, aggds, total_p2: int, live_p2: int,
                    n_parts: int):
    """Dispatch one stacked chain (plancache.run_all's device half).
    Stacked pooled operands go through :func:`fetch_sharded`; the bound
    scalars are [R] host arrays (excluded from h2d accounting by the
    kernel convention).  Returns host (n_cand, n_found, n_valid, mask,
    per_col) arrays with a leading partition-row axis."""
    flat: List[np.ndarray] = []
    for fp in tiers:
        flat.extend(fp)
    flat.append(idx_pad)
    for d, v, _lo, _hi in preds:
        flat.extend((d, v))
    for d, v in aggds:
        flat.extend((d, v))
    ops, missed = fetch_sharded(flat, mesh)
    it = iter(ops)
    dev_tiers = [[next(it) for _ in fp] for fp in tiers]
    dev_idx = next(it)
    dev_preds = [(next(it), next(it), lo, hi) for _d, _v, lo, hi in preds]
    dev_aggs = [(next(it), next(it)) for _ in aggds]
    rows = int(idx_pad.shape[0])
    abo = np.stack([np.stack(t, axis=1) for fb in bounds for t in fb],
                   axis=1) if any(bounds) else np.zeros((rows, 0, 3),
                                                        np.int64)
    note_shape("spmd_index_chain", mesh_key(mesh), rows, total_p2, live_p2,
               tuple(_dt(fp) + tuple(int(p.shape[1]) for p in fp)
                     for fp in tiers),
               str(idx_pad.dtype), _dt([p[0] for p in preds]),
               _dt([a[0] for a in aggds]))
    raw, mask_np = _chain.fused_chain(dev_tiers, abo, dev_idx, n_live,
                                      dev_preds, dev_aggs, total_p2,
                                      live_p2)
    counts, per_col = _chain.split_raw(
        raw, [a[0].dtype == np.float64 for a in aggds], _chain.N_COUNTS)
    _record_dispatch("spmd_index_chain", h2d=missed, d2h=[mask_np])
    _note_spmd(mesh, n_parts)
    return counts[0], counts[1], counts[2], mask_np, per_col


# ---------------------------------------------------------------------------
# batched select masks (STREAM_SELECT over all partitions at once)
# ---------------------------------------------------------------------------

def _stack_preds(entries, ranges_len: int, mesh: PartitionMesh
                 ) -> Optional[Tuple]:
    """Stack per-partition kernel predicates into [R, live_p2] operands
    plus [R] bound vectors.  ``entries`` is [(partition, preds, ...)];
    returns None when dtypes disagree across partitions (rare open-type
    drift — the python loop handles it)."""
    from ..kernels.columnar_ops import _prep_bounds
    preds0 = entries[0][1]
    dts = tuple(str(p[0].dtype) for p in preds0)
    for e in entries[1:]:
        if tuple(str(p[0].dtype) for p in e[1]) != dts:
            return None
    live_p2 = max(int(p[0].shape[0]) for e in entries for p in e[1])
    rows = rows_for(len(entries), mesh)
    datas, valids, los, his = [], [], [], []
    for j in range(ranges_len):
        dt0 = entries[0][1][j][0].dtype
        d_list = [e[1][j][0] for e in entries]
        v_list = [e[1][j][1] for e in entries]
        datas.append(stack_cache.stack(d_list, rows, live_p2, dt0))
        valids.append(stack_cache.stack(v_list, rows, live_p2, np.bool_,
                                        fill=False))
        lo_a = np.zeros(rows, dtype=dt0)
        hi_a = np.zeros(rows, dtype=dt0)
        for r, e in enumerate(entries):
            _d, _v, lo, hi = e[1][j]
            blo, bhi = _prep_bounds(_d, lo, hi)
            lo_a[r], hi_a[r] = blo, bhi
        los.append(lo_a)
        his.append(hi_a)
    return datas, valids, los, his, live_p2, rows


def batched_range_masks(batches: Sequence[Any],
                        ranges: Dict[str, Tuple[Any, Any]]
                        ) -> Optional[List[Optional[np.ndarray]]]:
    """All partitions' ``K.range_mask`` in one stacked K1 launch.  Returns
    per-partition boolean masks (None entries: partition needs the host
    path — empty batch or absent column), or None when the whole select
    should stay on the python loop."""
    mesh = active_mesh()
    if mesh is None or not ranges:
        return None
    from ..columnar import operators as O
    entries = []            # (partition index, preds)
    for i, b in enumerate(batches):
        if len(b) == 0:
            continue
        made = O.make_range_preds(b, ranges)
        if made is None:
            _FALLBACKS.inc()
            return None     # not vectorizable anywhere: row-engine path
        if made is O.EMPTY:
            continue        # host short-circuit (empty result)
        entries.append((i, made))
    if len(entries) < 2:
        return None         # nothing to gain from a collective dispatch
    stacked = _stack_preds(entries, len(ranges), mesh)
    if stacked is None:
        _FALLBACKS.inc()
        return None
    datas, valids, los, his, live_p2, rows = stacked
    k = len(datas)
    flat = list(datas) + list(valids)
    ops, missed = fetch_sharded(flat, mesh)
    note_shape("spmd_range_mask", mesh_key(mesh), rows, live_p2,
               _dt(datas))
    out = _ops.range_mask_rows(
        [(ops[j], ops[k + j], los[j], his[j]) for j in range(k)], rows,
        live_p2)
    _record_dispatch("spmd_range_mask", h2d=missed, d2h=[out])
    _note_spmd(mesh, len(entries))
    result: List[Optional[np.ndarray]] = [None] * len(batches)
    for r, (i, _preds) in enumerate(entries):
        result[i] = out[r, :len(batches[i])]
    return result


# ---------------------------------------------------------------------------
# batched fused select+aggregate (LOCAL_AGG over an exact-range select)
# ---------------------------------------------------------------------------

def batched_select_aggregate(batches: Sequence[Any],
                             ranges: Dict[str, Tuple[Any, Any]],
                             aggs: Dict[str, Tuple[str, str]]
                             ) -> Optional[List[Optional[Tuple]]]:
    """All partitions' ``fused_select_aggregate`` in one stacked K2
    launch.  Returns per-partition ``(row, survivors)`` results (None
    entries fall back to the per-partition kernel), or None when
    partitions disagree structurally and the loop should run."""
    mesh = active_mesh()
    if mesh is None or not ranges:
        return None
    from ..columnar import operators as O
    entries = []   # (i, preds, n, arrays, meta, batch)
    for i, b in enumerate(batches):
        n = len(b)
        if n == 0:
            continue
        made = O.make_range_preds(b, ranges)
        if made is None:
            _FALLBACKS.inc()
            return None
        if made is O.EMPTY:
            continue
        arrays, meta = O._kernel_agg_cols(b, aggs)
        entries.append((i, made, n, arrays, meta, b))
    if len(entries) < 2:
        return None
    sig0 = tuple((m[0], m[1], m[2]) for m in entries[0][4])
    adts = tuple(str(a[0].dtype) for a in entries[0][3])
    for e in entries[1:]:
        if tuple((m[0], m[1], m[2]) for m in e[4]) != sig0 \
                or tuple(str(a[0].dtype) for a in e[3]) != adts:
            _FALLBACKS.inc()
            return None
    stacked = _stack_preds(entries, len(ranges), mesh)
    if stacked is None:
        _FALLBACKS.inc()
        return None
    datas, valids, los, his, live_p2, rows = stacked
    live_p2 = max([live_p2] + [int(a[0].shape[0])
                               for e in entries for a in e[3]])
    if live_p2 != stacked[4]:
        return None      # pred/agg bucket split: loop path (rare)
    m = len(adts)
    adatas, avalids = [], []
    for j in range(m):
        dt0 = entries[0][3][j][0].dtype
        adatas.append(stack_cache.stack([e[3][j][0] for e in entries],
                                        rows, live_p2, dt0))
        avalids.append(stack_cache.stack([e[3][j][1] for e in entries],
                                         rows, live_p2, np.bool_,
                                         fill=False))
    k = len(datas)
    flat = list(datas) + list(valids) + adatas + avalids
    ops, missed = fetch_sharded(flat, mesh)
    note_shape("spmd_filter_aggregate", mesh_key(mesh), rows, live_p2,
               _dt(datas), _dt(adatas))
    raw, mask_np = _ops.filter_aggregate_rows(
        [(ops[j], ops[k + j], los[j], his[j]) for j in range(k)],
        [(ops[2 * k + j], ops[2 * k + m + j]) for j in range(m)], rows,
        live_p2)
    counts, per_col_a = _chain.split_raw(
        raw, [a.dtype == np.float64 for a in adatas], 1)
    _record_dispatch("spmd_filter_aggregate", h2d=missed, d2h=[mask_np])
    _note_spmd(mesh, len(entries))
    result: List[Optional[Tuple]] = [None] * len(batches)
    for r, (i, _preds, n, _arrays, meta, b) in enumerate(entries):
        res = {"count": int(counts[0][r]), "sums": [], "mins": [],
               "maxs": [], "cnts": []}
        for s, mn, mx, cnt in per_col_a:
            c = int(cnt[r])
            res["cnts"].append(c)
            res["sums"].append(s[r].item())
            res["mins"].append(mn[r].item() if c else None)
            res["maxs"].append(mx[r].item() if c else None)
        row_mask = mask_np[r]
        result[i] = O._finish_aggregate(
            aggs, meta, res, True,
            lambda bb=b, mm=row_mask, nn=n: bb.filter(mm[:nn]))
    return result


# ---------------------------------------------------------------------------
# hash repartitioning (MToNPartitioningConnector -> the exchange)
# ---------------------------------------------------------------------------

_EXCHANGE_KINDS = ("i64", "f64", "bool", "dt", "date")


def _exchange_plan(cparts: Sequence[Any], keys: Sequence[str], p: int
                   ) -> Optional[Tuple]:
    """The host half of :func:`exchange_batches` before the send buffer:
    (each column's (data, validity) a source, rows a source, the key (the
    index of the column the card hashes, or each source's partition ids
    from ``operators.partition_ids``), names, kinds), or None where the
    exchange stays host-side."""
    mesh = active_mesh()
    if mesh is None or mesh.lanes != p or p < 2 \
            or p > _ops.EXCHANGE_MAX_P:
        return None
    from ..columnar import operators as O
    schema: Optional[Tuple] = None
    for b in cparts:
        if not len(b):
            continue
        sig = tuple(sorted((nm, c.kind) for nm, c in b.columns.items()))
        if any(kd not in _EXCHANGE_KINDS for _nm, kd in sig):
            return None
        if schema is None:
            schema = sig
        elif sig != schema:
            _FALLBACKS.inc()
            return None
    if not schema:
        return None                      # all partitions empty: host path
    names = [nm for nm, _kd in schema]
    kinds = dict(schema)
    rows = [len(b) for b in cparts]
    ref = next(b for b in cparts if len(b))
    cols = []
    for nm in names:
        dt0 = ref.columns[nm].data.dtype
        empty = (np.zeros(0, dt0), np.zeros(0, bool))
        cols.append([(b.columns[nm].data, b.columns[nm].valid) if len(b)
                     else empty for b in cparts])
    # one int64 or bool key column, every row valid: hashed on the card as
    # partition_ids hashes it (hash_partition_array); any other key takes
    # the host's ids
    k = keys[0] if len(keys) == 1 else None
    if k in kinds and kinds[k] in ("i64", "bool") and all(
            b.columns[k].valid[:len(b)].all() for b in cparts if len(b)):
        key: Any = names.index(k)
    else:
        key = [O.partition_ids(b, keys, p) if len(b)
               else np.zeros(0, np.int64) for b in cparts]
    return cols, rows, key, names, kinds


def _exchange_views(host: np.ndarray, lay: Any, names: Sequence[str],
                    kinds: Dict[str, str]) -> Tuple[List[Any], int]:
    """(each destination's ColumnBatch, rows moved) from the received
    buffer: every column a numpy view of it."""
    from ..columnar.batch import Column, ColumnBatch
    counts, got = _ops.received(host, lay)
    per_dest = counts.sum(axis=0)
    out: List[Any] = []
    a = 0
    for j in range(lay.p):
        z = a + int(per_dest[j])
        if z == a:
            out.append(ColumnBatch({}, 0))
            continue
        out.append(ColumnBatch(
            {nm: Column(kinds[nm], d[a:z], v[a:z], None)
             for nm, (d, v) in zip(names, got)}, z - a))
        a = z
    return out, lay.n - int(np.trace(counts))


def exchange_batches(cparts: Sequence[Any], keys: Sequence[str], p: int
                     ) -> Optional[Tuple[List[Any], int]]:
    """Hash-repartition ColumnBatches across the mesh's lanes with one
    exchange dispatch (MToNPartitioningConnector).  Placement and row
    order are bit-identical to the host bucketing path (same
    ``partition_ids`` hash; destination j receives source 0's rows bound
    for j, then source 1's, ..., each in their order).  The sources' rows
    go up as they are, in one buffer with the key or the host's partition
    ids, and the card partitions them (``kernels/spmd_ops``); each
    destination's columns are views of the one buffer that comes back.
    Returns (batches, rows moved), or None when the exchange must stay
    host-side: lanes != partition count, fewer than 2 or more than
    ``EXCHANGE_MAX_P`` partitions, schema drift across partitions, or
    non-numeric (string/obj) columns whose dictionary codes are
    partition-local."""
    plan = _exchange_plan(cparts, keys, p)
    if plan is None:
        return None
    from ..columnar.batch import pow2_len
    cols, rows, key, names, kinds = plan
    mesh = active_mesh()
    stage, lay = _ops.stage_exchange(cols, rows, key, p)
    if lay.key_kind == _ops.XK_PID:
        _HOST_PIDS.inc()
    note_shape("spmd_exchange", mesh_key(mesh), pow2_len(lay.n),
               tuple(str(c[0]) for c in lay.cols), lay.key_kind)
    dev = target()
    if dev.type == "cuda":
        recv = _ops.exchange_cuda(stage.to(dev, non_blocking=True), lay)
    else:
        recv = _ops.exchange_plain(stage, lay)
    host = _ops.download(recv)
    _record_dispatch("spmd_exchange", h2d=[stage.numpy()], d2h=[host])
    _note_spmd(mesh, p)
    out, moved = _exchange_views(host, lay, names, kinds)
    _EXCH_ROWS.inc(moved)
    return out, moved


# ---------------------------------------------------------------------------
# merges of partial aggregates over the stacked rows
# ---------------------------------------------------------------------------

def _collective_merge(parts: np.ndarray, op: str,
                      mesh: Optional[PartitionMesh]) -> np.ndarray:
    m = mesh if mesh is not None else active_mesh()
    if m is None:
        raise RuntimeError("no active partition mesh")
    parts = np.asarray(parts)
    if parts.ndim == 1:            # [P] partials: one column ([1] out)
        parts = parts[:, None]
    rows = rows_for(parts.shape[0], m)
    if rows != parts.shape[0]:
        if op == "sum":
            fill = np.zeros((rows - parts.shape[0], parts.shape[1]),
                            dtype=parts.dtype)
        else:
            if np.issubdtype(parts.dtype, np.integer):
                info = np.iinfo(parts.dtype)
                ident = info.max if op == "min" else info.min
            else:
                ident = np.inf if op == "min" else -np.inf
            fill = np.full((rows - parts.shape[0], parts.shape[1]),
                           ident, dtype=parts.dtype)
        parts = np.concatenate([parts, fill])
    note_shape("spmd_merge", mesh_key(m), op, parts.shape,
               str(parts.dtype))
    out = _ops.merge_rows(parts, op)
    _record_dispatch(f"spmd_merge_{op}", d2h=[out])
    _note_spmd(m, parts.shape[0])
    return out


def psum_merge(parts: np.ndarray,
               mesh: Optional[PartitionMesh] = None) -> np.ndarray:
    """Column-wise sum of per-partition partial aggregates [P, M] -> [M]
    (GLOBAL_AGG's sum/count merge as one launch)."""
    return _collective_merge(parts, "sum", mesh)


def pmin_merge(parts: np.ndarray,
               mesh: Optional[PartitionMesh] = None) -> np.ndarray:
    return _collective_merge(parts, "min", mesh)


def pmax_merge(parts: np.ndarray,
               mesh: Optional[PartitionMesh] = None) -> np.ndarray:
    return _collective_merge(parts, "max", mesh)
