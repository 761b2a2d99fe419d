"""Compiled fused Figure-6 chains (rung 3): one cached dispatch per plan
shape.

The per-operator columnar index path (``lower._compile_index_path``) runs
a secondary-index chain as a handful of kernel dispatches per partition:
CSR probe scatter, extra-field bitmap ANDs, validate-range mask, then —
under a LOCAL_AGG — the fused filter+aggregate reduction, with the
candidate bitmap round-tripping to host between every step.  This module
runs the whole chain

    index probe -> bitmap AND -> live gather -> filter / aggregate

as one dispatch of A6 (``kernels/chain_ops``, CUDA kernel
``csrc/fused_chain.cu``) whose operands are the device-resident pooled
buffers (``kernels/device_pool``): the per-tier pow2-padded CSR
positions arrays, the live-selection index, and the partition batch's
padded columns.  Probe bounds travel as per-row scalars, so a repeated
query over a warm pool is one dispatch with ``h2d_bytes == 0`` and zero
retraces.

Plan shapes are keyed as the reference keys them (its
``repro/columnar/plancache.py``): the chain's op sequence plus every
shape-relevant static — pow2 buckets of the storage concat and live
selection, per-field tier shape tuples, predicate/aggregate dtypes, the
mesh.  The :class:`PlanCache` records first sightings
(``plan_cache.misses``) vs. repeats (``plan_cache.hits``), and A6's
``kernel_retraces`` rise once per new (buckets, tier widths, dtypes)
shape, where the reference's jit core would trace.

Declines are cheap and total: any input the fused dispatch cannot
represent exactly (unordered key dictionary, obj-degraded validate
column, fuzzy chains, live/storage mismatches mid-race) returns None and
the caller falls back to the per-operator path — results are
bit-identical either way.  A6 takes any number of validate ranges, as
the reference's chain does.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..kernels import chain_ops as _chain
from ..kernels import device_pool as _pool
from ..kernels.columnar_ops import note_shape
from ..obs import record_dispatch as _record_dispatch
from .batch import ColumnBatch, pow2_len

__all__ = ["PlanCache", "plan_cache", "set_enabled", "totals",
           "compile_chain", "ChainResult", "empty_partition_agg"]

_HITS = obs.counter("plan_cache.hits")
_MISSES = obs.counter("plan_cache.misses")
_ENTRIES = obs.gauge("plan_cache.entries")

class PlanCache:
    """Plan-shape accounting for the fused chain dispatch: which shapes
    have been seen (hit/miss/entries metrics survive ``obs.reset`` via the
    internal tallies, which :func:`totals` exposes for ExecStats
    diffing)."""

    def __init__(self) -> None:
        self._keys: set = set()
        self._hits = 0
        self._misses = 0
        self._lock = threading.Lock()       # concurrent queries note too
        self.enabled = True

    def note(self, key: Tuple) -> bool:
        """Record one fused dispatch under plan shape ``key``; True if the
        shape was already compiled (a cache hit)."""
        with self._lock:
            hit = key in self._keys
            if hit:
                self._hits += 1
            else:
                self._keys.add(key)
                self._misses += 1
            entries = len(self._keys)
        (_HITS if hit else _MISSES).inc()
        # set (not inc) every note: the gauge resurvives obs.reset()
        _ENTRIES.set(entries)
        return hit

    def totals(self) -> Tuple[int, int]:
        with self._lock:
            return self._hits, self._misses

    def entry_count(self) -> int:
        return len(self._keys)

    def clear(self) -> None:
        """Forget seen plan shapes (metrics accounting only — the
        kernels' seen shapes persist, so re-seen shapes re-warm without a
        retrace)."""
        with self._lock:
            self._keys.clear()
        _ENTRIES.set(0)


plan_cache = PlanCache()


def set_enabled(v: bool) -> None:
    """Disable to force every chain down the per-operator legacy path
    (the differential harness runs both and compares)."""
    plan_cache.enabled = bool(v)


def totals() -> Tuple[int, int]:
    return plan_cache.totals()


# ---------------------------------------------------------------------------
# host wrapper: gather operands, key the shape, dispatch, assemble
# ---------------------------------------------------------------------------

class ChainResult:
    """One partition's fused chain outcome.  ``batch`` carries the
    gathered survivors (mask mode) or None (aggregate mode, where ``row``
    holds the partial-aggregate row instead)."""

    __slots__ = ("batch", "row", "n_cand", "n_found", "n_valid")

    def __init__(self, batch, row, n_cand, n_found, n_valid):
        self.batch = batch
        self.row = row
        self.n_cand = n_cand
        self.n_found = n_found
        self.n_valid = n_valid


def _field_tiers(ds: Any, i: int, fld: str, lo: Any, hi: Any
                 ) -> Optional[Tuple[List[np.ndarray], List[Tuple], int,
                                     np.ndarray]]:
    """(padded per-tier positions, per-tier (a, b, off) bounds, storage
    concat length, live index) for one range field, or None when any tier
    defeats the fused representation (unordered keys, unencodable
    bounds)."""
    sources, total, idx = ds.secondary_fused_inputs(i, fld)
    pads: List[np.ndarray] = []
    abs_: List[Tuple] = []
    for off, p in sources:
        ab = p.range_offsets(lo, hi)
        if ab is None:
            return None
        pads.append(p.padded_positions())
        abs_.append((ab[0], ab[1], off))
    return pads, abs_, total, idx


def compile_chain(ds: Any, *, chain_ops: Tuple[str, ...], search_field: str,
                  search_bounds: Tuple[Any, Any],
                  extra: Sequence[Tuple[str, Any, Any]],
                  validate_ranges: Dict[str, Tuple[Any, Any]],
                  pred: Optional[Any], residual: bool,
                  fields: Sequence[str],
                  aggs: Optional[Dict[str, Tuple[str, str]]] = None):
    """Compile-time half of the fused chain: returns a per-partition
    runner ``run(i, cols) -> Optional[ChainResult]`` or None when the
    chain can never fuse (dataset without the raw-operand surface,
    aggregate mode with a residual row predicate — the gathered-survivor
    semantics the core cannot reduce on-device)."""
    if not hasattr(ds, "secondary_fused_inputs"):
        return None
    if aggs is not None and residual and pred is not None:
        # legacy aggregates the row-checked survivors; the core cannot
        return None
    range_fields = [(search_field, search_bounds[0], search_bounds[1])]
    range_fields += [tuple(e) for e in extra]

    def _gather(i: int, cols: Optional[Sequence[str]]
                ) -> Optional[Dict[str, Any]]:
        """One partition's fused-chain operands, or None when this
        partition defeats the fused representation and must run the
        per-operator legacy path.  An ``{"empty": True}`` marker flags a
        short-circuitable partition (no storage / no live rows) — the
        loop path declines those to legacy, and ``run_all`` hands them
        back as per-partition fallbacks for exactly the same reason."""
        from . import operators as O
        tiers: List[Tuple[np.ndarray, ...]] = []
        bounds: List[Tuple[Tuple, ...]] = []
        total0 = idx0 = None
        for fld, lo, hi in range_fields:
            ft = _field_tiers(ds, i, fld, lo, hi)
            if ft is None:
                return None
            pads, abs_, total, idx = ft
            if total0 is None:
                total0, idx0 = total, idx
            elif total != total0 or idx is not idx0:
                return None        # raced a writer between field probes
            tiers.append(tuple(pads))
            bounds.append(tuple(abs_))
        n_live = int(idx0.shape[0])
        if total0 == 0 or n_live == 0:
            return {"empty": True}  # legacy short-circuits these for free
        batch = ds.scan_partition_batch(i, cols)
        if len(batch) != n_live:
            return None            # raced a writer between probe and scan
        preds = []
        if validate_ranges:
            made = O.make_range_preds(batch, validate_ranges)
            if made is None or made is O.EMPTY:
                return None
            preds = made
        agg_arrays: List[Tuple[np.ndarray, np.ndarray]] = []
        agg_meta: List[Tuple] = []
        if aggs is not None:
            agg_arrays, agg_meta = O._kernel_agg_cols(batch, aggs)
        total_p2 = pow2_len(total0)
        idx_pad = _pool.padded(idx0, fill="zero")
        live_p2 = int(idx_pad.shape[0])
        # every padded column must sit in the same pow2 bucket as the
        # live selection, or the core's mask/data shapes disagree
        if any(int(d.shape[0]) != live_p2 for d, _v, _lo, _hi in preds) \
                or any(int(d.shape[0]) != live_p2 for d, _v in agg_arrays):
            return None
        return {"tiers": tiers, "bounds": bounds, "total_p2": total_p2,
                "idx_pad": idx_pad, "live_p2": live_p2, "n_live": n_live,
                "batch": batch, "preds": preds, "agg_arrays": agg_arrays,
                "agg_meta": agg_meta}

    def _assemble(batch: ColumnBatch, n_live: int, mask_np: np.ndarray,
                  per_col: Sequence[Tuple], agg_meta: Sequence[Tuple],
                  n_cand: int, n_found: int, n_valid: int
                  ) -> ChainResult:
        """Shared result assembly for the loop and SPMD dispatch paths
        (``per_col`` scalars arrive as 0-d device results or stacked-row
        slices; both support ``.item()``)."""
        from . import operators as O
        if aggs is None:
            got = batch.filter(mask_np[:n_live])
            if residual and pred is not None and len(got):
                view = got.project(list(fields)) if fields else got
                rows = view.to_rows()
                keep = np.fromiter((bool(pred(r)) for r in rows),
                                   dtype=bool, count=len(rows))
                got = got.filter(keep)
            return ChainResult(got, None, n_cand, n_found, len(got))

        # aggregate mode: device scalars for kernelable columns, one host
        # pass over the gathered survivors for the rest — exactly
        # ``operators.aggregate_batch`` over the filtered batch
        row: Dict[str, Any] = {}
        by_name = {m[0]: (j, m) for j, m in enumerate(agg_meta)}
        got = None
        for name, (fn, cname) in aggs.items():
            if fn == "count" and cname == "*":
                row[name] = n_valid
                continue
            if name in by_name and by_name[name][1][1] == fn:
                j, (_, _, kind, col) = by_name[name]
                s, mn, mx, c = per_col[j]
                c = int(c)
                s = s.item()
                mn = O._decode_agg(mn.item() if c else None, kind, col)
                mx = O._decode_agg(mx.item() if c else None, kind, col)
                if kind == "i64" and isinstance(s, float):
                    s = int(s)
                O._finish_agg(row, name, fn, True, c, s, mn, mx)
                continue
            if got is None:        # numpy gather, no kernel dispatch
                got = batch.filter(mask_np[:n_live])
            vals = got.to_rows() if cname == "*" \
                else O._py_agg_vals(got, cname)
            reduce_sum = fn in ("sum", "avg") and vals and cname != "*"
            O._finish_agg(row, name, fn, True, len(vals),
                          sum(vals) if reduce_sum else 0,
                          min(vals) if (fn == "min" and vals
                                        and cname != "*") else None,
                          max(vals) if (fn == "max" and vals
                                        and cname != "*") else None)
        return ChainResult(None, row, n_cand, n_found, n_valid)

    def run(i: int, cols: Optional[Sequence[str]]
            ) -> Optional[ChainResult]:
        if not plan_cache.enabled:
            return None
        g = _gather(i, cols)
        if g is None or g.get("empty"):
            return None
        tiers, bounds = g["tiers"], g["bounds"]
        preds, agg_arrays = g["preds"], g["agg_arrays"]
        total_p2, live_p2 = g["total_p2"], g["live_p2"]
        idx_pad, n_live = g["idx_pad"], g["n_live"]
        key = (chain_ops, total_p2, live_p2,
               tuple(tuple(int(p.shape[0]) for p in fp) for fp in tiers),
               tuple(str(d.dtype) for d, _v, _lo, _hi in preds),
               tuple(str(d.dtype) for d, _v in agg_arrays),
               aggs is not None, _spmd().mesh_key())
        plan_cache.note(key)

        flat: List[np.ndarray] = []
        for fp in tiers:
            flat.extend(fp)
        flat.append(idx_pad)
        for d, v, _lo, _hi in preds:
            flat.extend((d, v))
        for d, v in agg_arrays:
            flat.extend((d, v))
        ops, missed = _pool.fetch(flat)
        # one partition: every operand a one-row view
        it = iter(t.view(1, -1) for t in ops)
        dev_tiers = [[next(it) for _ in fp] for fp in tiers]
        dev_idx = next(it)
        dev_preds = []
        for _d, _v, lo, hi in preds:
            dd, dv = next(it), next(it)
            blo, bhi = _prep_pred_bounds(_d, lo, hi)
            dev_preds.append((dd, dv, blo.reshape(1), bhi.reshape(1)))
        dev_aggs = [(next(it), next(it)) for _ in agg_arrays]
        abo = np.asarray([[t for fb in bounds for t in fb]],
                         dtype=np.int64).reshape(1, -1, 3)
        note_shape("fused_index_chain", total_p2, live_p2,
                   tuple(tuple((str(p.dtype), int(p.shape[0])) for p in fp)
                         for fp in tiers),
                   str(idx_pad.dtype),
                   tuple(str(d.dtype) for d, _v, _lo, _hi in preds),
                   tuple(str(d.dtype) for d, _v in agg_arrays))
        raw, mask = _chain.fused_chain(dev_tiers, abo, dev_idx,
                                       np.asarray([n_live], np.int64),
                                       dev_preds, dev_aggs, total_p2,
                                       live_p2)
        counts, per_col_a = _chain.split_raw(
            raw, [d.dtype == np.float64 for d, _v in agg_arrays],
            _chain.N_COUNTS)
        n_cand, n_found, n_valid = (int(c[0]) for c in counts)
        per_col = [tuple(x[0] for x in pc) for pc in per_col_a]
        mask_np = mask[0]
        _record_dispatch("fused_index_chain", h2d=missed, d2h=[mask_np])
        return _assemble(g["batch"], n_live, mask_np, per_col,
                         g["agg_meta"], n_cand, n_found, n_valid)

    def run_all(cols: Optional[Sequence[str]]
                ) -> Optional[List[Optional[ChainResult]]]:
        """All partitions' chains as one stacked A6 dispatch over the
        active partition mesh.  Returns a per-partition result
        list (None entries: that partition declined and must run the
        loop/legacy path), or None when the whole query should fall
        back to the per-partition loop (no mesh, fewer than two
        stackable partitions, or cross-partition operand drift)."""
        spmd = _spmd()
        mesh = spmd.active_mesh()
        if mesh is None or not plan_cache.enabled:
            return None
        P = int(ds.num_partitions)
        gathered: List[Optional[Dict[str, Any]]] = []
        entries: List[Tuple[int, Dict[str, Any]]] = []
        for i in range(P):
            g = _gather(i, cols)
            gathered.append(g)
            if g is not None and not g.get("empty"):
                entries.append((i, g))
        if len(entries) < 2:
            spmd.note_fallback()
            return None
        g0 = entries[0][1]
        n_fields = len(g0["tiers"])
        pred_sig = tuple(str(d.dtype) for d, _v, _lo, _hi in g0["preds"])
        agg_sig = tuple(str(d.dtype) for d, _v in g0["agg_arrays"])
        meta_sig = tuple((m[0], m[1], m[2]) for m in g0["agg_meta"])
        for _i, g in entries[1:]:
            if (len(g["tiers"]) != n_fields
                    or tuple(str(d.dtype) for d, _v, _lo, _hi
                             in g["preds"]) != pred_sig
                    or tuple(str(d.dtype)
                             for d, _v in g["agg_arrays"]) != agg_sig
                    or tuple((m[0], m[1], m[2])
                             for m in g["agg_meta"]) != meta_sig):
                spmd.note_fallback()
                return None
        # common buckets: every partition pads into the max pow2 bucket
        # (exact — see kernels/chain_ops) and missing tier slots become
        # zero-width (0, 0, 0) slices that scatter nothing
        total_p2 = max(g["total_p2"] for _i, g in entries)
        live_p2 = max(g["live_p2"] for _i, g in entries)
        n_tiers = [max(len(g["tiers"][f]) for _i, g in entries)
                   for f in range(n_fields)]
        tier_w = [[max((int(g["tiers"][f][t].shape[0])
                        for _i, g in entries if t < len(g["tiers"][f])),
                       default=1)
                   for t in range(n_tiers[f])] for f in range(n_fields)]
        rows = spmd.rows_for(len(entries), mesh)
        key = (chain_ops, total_p2, live_p2,
               tuple(tuple(w for w in tier_w[f]) for f in range(n_fields)),
               pred_sig, agg_sig, aggs is not None,
               spmd.mesh_key(mesh), rows, "spmd")
        plan_cache.note(key)

        sc = spmd.stack_cache
        st_tiers = []
        st_bounds = []
        for f in range(n_fields):
            fp, fb = [], []
            for t in range(n_tiers[f]):
                arrs = [g["tiers"][f][t] if t < len(g["tiers"][f]) else None
                        for _i, g in entries]
                dt = next(a.dtype for a in arrs if a is not None)
                fp.append(sc.stack(arrs, rows, tier_w[f][t], dt))
                a_v = np.zeros(rows, np.int64)
                b_v = np.zeros(rows, np.int64)
                o_v = np.zeros(rows, np.int64)
                for r, (_i, g) in enumerate(entries):
                    if t < len(g["bounds"][f]):
                        a, b, off = g["bounds"][f][t]
                        a_v[r], b_v[r], o_v[r] = a, b, off
                fb.append((a_v, b_v, o_v))
            st_tiers.append(tuple(fp))
            st_bounds.append(tuple(fb))
        idx_st = sc.stack([g["idx_pad"] for _i, g in entries], rows,
                          live_p2, g0["idx_pad"].dtype)
        n_live_v = np.zeros(rows, np.int64)
        for r, (_i, g) in enumerate(entries):
            n_live_v[r] = g["n_live"]
        st_preds = []
        for j in range(len(pred_sig)):
            d0 = g0["preds"][j][0]
            dd = sc.stack([g["preds"][j][0] for _i, g in entries], rows,
                          live_p2, d0.dtype)
            vv = sc.stack([g["preds"][j][1] for _i, g in entries], rows,
                          live_p2, np.bool_, fill=False)
            lo_v = np.zeros(rows, d0.dtype)
            hi_v = np.zeros(rows, d0.dtype)
            for r, (_i, g) in enumerate(entries):
                _d, _v, lo, hi = g["preds"][j]
                blo, bhi = _prep_pred_bounds(_d, lo, hi)
                lo_v[r], hi_v[r] = blo, bhi
            st_preds.append((dd, vv, lo_v, hi_v))
        st_aggs = []
        for j in range(len(agg_sig)):
            d0 = g0["agg_arrays"][j][0]
            dd = sc.stack([g["agg_arrays"][j][0] for _i, g in entries],
                          rows, live_p2, d0.dtype)
            vv = sc.stack([g["agg_arrays"][j][1] for _i, g in entries],
                          rows, live_p2, np.bool_, fill=False)
            st_aggs.append((dd, vv))
        n_cand_a, n_found_a, n_valid_a, mask_a, per_col_a = \
            spmd.run_chain_stack(mesh, tuple(st_tiers), tuple(st_bounds),
                                 idx_st, n_live_v, tuple(st_preds),
                                 tuple(st_aggs), total_p2, live_p2,
                                 len(entries))
        out: List[Optional[ChainResult]] = [None] * P
        for r, (i, g) in enumerate(entries):
            per_col = [tuple(x[r] for x in pc) for pc in per_col_a]
            out[i] = _assemble(g["batch"], g["n_live"], mask_a[r],
                               per_col, g["agg_meta"], int(n_cand_a[r]),
                               int(n_found_a[r]), int(n_valid_a[r]))
        return out

    run.run_all = run_all
    return run


def _spmd():
    """Lazy handle on the partition runtime (``runtime/spmd`` imports the
    kernels, and the executor imports this module first)."""
    from ..runtime import spmd
    return spmd


def _prep_pred_bounds(data: np.ndarray, lo: Any, hi: Any
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Same-dtype 0-d bound operands (unbounded -> dtype extremes), the
    ``columnar_ops._prep_bounds`` contract."""
    from ..kernels.columnar_ops import _prep_bounds
    return _prep_bounds(data, lo, hi)


def empty_partition_agg(aggs: Dict[str, Tuple[str, str]]) -> Dict[str, Any]:
    """The partial-aggregate row of an empty partition (what the legacy
    LOCAL_AGG computes for short-circuited / padding partitions)."""
    from . import operators as O
    row, _ = O.aggregate_batch(ColumnBatch({}, 0), aggs, partial=True)
    return row
