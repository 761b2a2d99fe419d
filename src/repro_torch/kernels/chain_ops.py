"""A6: the fused secondary-index chain (probe -> bitmap AND -> live gather
-> validate ranges -> aggregate) as one dispatch, on PyTorch with a
hand-written CUDA kernel (``csrc/fused_chain.cu``).

The reference compiles the chain into one jit core
(``repro/columnar/plancache.py:_chain_math``) that ``columnar/plancache``
runs once per partition, and ``runtime/spmd`` once over the stacked
partition axis.  Here both are one call of :func:`fused_chain` with a
leading row axis: one row in the partition loop, every stacked partition
row on the partition mesh.

Operands (``R`` rows):

  tiers     per range field, per tier: posting positions [R, width]
            (int32 or int64, the postings' own dtype)
  abo       int64 [R, tiers of every field, 3]: each tier's slice [a, b)
            and its offset into the storage concat
  idx       int64 [R, live_p2]: the live-selection slot of every lane
  n_live    int64 [R]: live lanes a row (lanes past it are padding)
  preds     (data [R, live_p2], valid, lo [R], hi [R]): validate ranges,
            the bounds in the data's dtype
  aggs      (data [R, live_p2], valid): aggregate columns

It returns ``raw`` int64 [R, 3 + 4 M] — n_cand, n_found, n_valid, then a
column's valid survivors, sum, min and max, float64 slots as raw bits —
and the survivor mask [R, live_p2], both on the host.  A CUDA ``idx``
launches the kernels (a scatter and a gather / reduce launch, see the
source) or raises; a CPU one
runs :func:`chain_plain`, the reference's math in PyTorch, whose float64
sums fold in ``columnar_ops.tree_sum``'s order, as the kernel's do.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import columnar_ops as CO
from . import ops as _ops
from .columnar_ops import bound_bits, range_mask_rows_cuda

__all__ = ["fused_chain", "chain_plain", "chain_cuda", "agg_slots_plain",
           "split_raw", "unpack", "N_COUNTS"]

N_COUNTS = 3                 # n_cand, n_found, n_valid
_POS_DTYPES = (torch.int64, torch.int32)


def _bits(x: torch.Tensor) -> int:
    """A 0-d int64 or float64 tensor as an int64 slot (floats as bits)."""
    if x.dtype == torch.float64:
        return int(x.reshape(1).view(torch.int64)[0])
    return int(x)


def agg_slots_plain(mask: torch.Tensor, acols: Sequence[Tuple]
                    ) -> List[int]:
    """One row's aggregate slots: per column (valid survivors, sum, min,
    max) as int64 values, float64 ones as raw bits, folded as K2 folds
    them (float64 sums in ``tree_sum``'s order, NaN propagating)."""
    out: List[int] = []
    for x, v in acols:
        ok = mask & v
        if x.dtype == torch.float64:
            s = CO.tree_sum(torch.where(ok, x, 0.0))
            mn = torch.where(ok, x, float("inf")).min()
            mx = torch.where(ok, x, float("-inf")).max()
        else:
            x = x.to(torch.int64)
            info = torch.iinfo(torch.int64)
            s = torch.where(ok, x, 0).sum()
            mn = torch.where(ok, x, info.max).min()
            mx = torch.where(ok, x, info.min).max()
        out += [int(ok.sum()), _bits(s), _bits(mn), _bits(mx)]
    return out


def chain_plain(tiers: Sequence[Sequence[torch.Tensor]], abo: np.ndarray,
                idx: torch.Tensor, n_live: np.ndarray, preds: Sequence,
                aggs: Sequence, total_p2: int, live_p2: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """A6's plain version: ``_chain_math`` row by row."""
    dev = idx.device
    rows = int(idx.shape[0])
    lane = torch.arange(live_p2, device=dev)[None, :] \
        < torch.from_numpy(np.asarray(n_live, np.int64)).to(dev)[:, None]
    slots = idx.clamp(0, total_p2 - 1)
    field_masks = []
    t_all = 0
    for fp in tiers:
        flags = torch.zeros((rows, total_p2), dtype=torch.bool, device=dev)
        for pos in fp:
            for r in range(rows):
                a, b, off = (int(v) for v in abo[r, t_all])
                w = int(pos.shape[1])
                seg = pos[r, max(a, 0):min(b, w)].to(torch.int64) + off
                seg = seg[(seg >= 0) & (seg < total_p2)]
                flags[r, seg] = True
            t_all += 1
        field_masks.append(torch.gather(flags, 1, slots))
    cand = field_masks[0] & lane
    found = cand
    for m in field_masks[1:]:
        found = found & m
    mask = found
    for data, valid, lo, hi in preds:
        lo_t = torch.from_numpy(np.asarray(lo)).to(dev)[:, None]
        hi_t = torch.from_numpy(np.asarray(hi)).to(dev)[:, None]
        mask = mask & valid & (data >= lo_t) & (data <= hi_t)
    raw = np.zeros((rows, N_COUNTS + 4 * len(aggs)), dtype=np.int64)
    for r in range(rows):
        raw[r, :N_COUNTS] = (int(cand[r].sum()), int(found[r].sum()),
                             int(mask[r].sum()))
        raw[r, N_COUNTS:] = agg_slots_plain(
            mask[r], [(d[r], v[r]) for d, v in aggs])
    return raw, mask.cpu().numpy()


def _check_cols(cols: Sequence[Tuple], rows: int, n: int) -> None:
    for j, c in enumerate(cols):
        x, v = c[0], c[1]
        if tuple(x.shape) != (rows, n) or tuple(v.shape) != (rows, n):
            raise ValueError(f"column {j}: [{rows}, {n}] operands expected, "
                             f"got {tuple(x.shape)} and {tuple(v.shape)}")


def unpack(host: np.ndarray, rows: int, w: int, n: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """A packed result buffer (int64 [rows, w], then bool [rows, n]), on
    the host, as (raw, mask) views."""
    raw = host[:rows * w * 8].view(np.int64).reshape(rows, w)
    return raw, host[rows * w * 8:].view(np.bool_).reshape(rows, n)


_MAX_STAMP = 255
# per (device, stream): the flag buffer A6's dispatches stamp (uint8,
# grown to the largest [R, fields, total_p2] seen) and the last stamp
# given; every byte is 0 or an earlier stamp since the buffer was zeroed.
# Taken and used only under the stream's lock (``ops.stream_lock``)
_FLAGS: Dict[Tuple[int, int], list] = {}


def _flag_buffer(dev: torch.device, nbytes: int
                 ) -> Tuple[torch.Tensor, int, int]:
    """(buffer, stamp, clear_bytes) for one dispatch: the next stamp in 1
    .. 255, and the bytes to zero first (the whole buffer when it is new
    or the stamp wraps, else 0).  The caller holds the stream's lock from
    here through the C call that stamps and reads the buffer."""
    key = _ops.stream_key(dev)
    got = _FLAGS.get(key)
    if got is None or got[0].numel() < nbytes:
        got = _FLAGS[key] = [torch.empty(nbytes, dtype=torch.uint8,
                                         device=dev), _MAX_STAMP]
    stamp = got[1] % _MAX_STAMP + 1
    got[1] = stamp
    return got[0], stamp, got[0].numel() if stamp == 1 else 0


def chain_cuda(tiers: Sequence[Sequence[torch.Tensor]], abo: np.ndarray,
               idx: torch.Tensor, n_live: np.ndarray, preds: Sequence,
               aggs: Sequence, total_p2: int, live_p2: int) -> torch.Tensor:
    """A6 on the card, one C call: the scatter launch, then the gather /
    compare / reduce launch (one per 8 aggregate columns), and a memset of
    the pooled flags first when they are new or their stamp wraps
    (counted in ``chain_cuda.clears``); with more than 8 validate ranges,
    one stacked K1 launch before it (``columnar_ops.fold_extra_preds``).
    The per-row scalars go up in one copy.  The stamp and the C call hold
    the stream's lock, so dispatches from concurrent threads do not
    interleave their launches.  Returns the packed result on the card
    (:func:`unpack`'s layout: counts and column scalars, then the mask),
    which comes back in one copy."""
    dev = idx.device
    rows, nf, m = int(idx.shape[0]), len(tiers), len(aggs)
    if not (idx.is_cuda and idx.dtype == torch.int64
            and idx.is_contiguous() and tuple(idx.shape) == (rows, live_p2)):
        raise TypeError("fused_index_chain: a contiguous CUDA int64 "
                        "[rows, live_p2] live-selection index expected")
    flat = [t for fp in tiers for t in fp]
    for t in flat:
        if not (t.is_cuda and t.dtype in _POS_DTYPES and t.is_contiguous()
                and t.dim() == 2 and t.shape[0] == rows):
            raise TypeError("fused_index_chain: contiguous CUDA int32 / "
                            "int64 [rows, width] positions expected")
    _check_cols(preds, rows, live_p2)
    _check_cols(aggs, rows, live_p2)
    preds = CO.fold_extra_preds(
        preds, lambda cols: range_mask_rows_cuda(cols, rows, live_p2))
    # the per-row scalars in one upload: bounds, (a, b, off), n_live
    bb = bound_bits([p[2] for p in preds], [p[3] for p in preds]) \
        if preds else np.zeros((rows, 0, 2), np.int64)
    abo = np.ascontiguousarray(abo, dtype=np.int64)
    small = np.concatenate([bb.reshape(-1), abo.reshape(-1),
                            np.asarray(n_live, np.int64).reshape(-1)])
    small_d = torch.from_numpy(small).to(dev)
    nb = bb.size
    bounds_p = small_d.data_ptr()
    abo_p = bounds_p + 8 * nb
    nlive_p = abo_p + 8 * abo.size
    nt = len(flat)
    pos_arr = (ctypes.c_void_p * max(nt, 1))(*[t.data_ptr() for t in flat])
    width = (ctypes.c_int64 * max(nt, 1))(*[int(t.shape[1]) for t in flat])
    field = (ctypes.c_int * max(nt, 1))(
        *[f for f, fp in enumerate(tiers) for _ in fp])
    is32 = (ctypes.c_int * max(nt, 1))(
        *[int(t.dtype == torch.int32) for t in flat])
    lens = (np.clip(abo[:, :, 1], 0, None) - np.clip(abo[:, :, 0], 0, None))
    max_len = int(lens.max()) if lens.size else 0
    pcols = [(d, v, None, None) for d, v, _lo, _hi in preds]
    acols = [(d, v, None, None) for d, v in aggs]
    pd, ad = CO._descs(pcols), CO._descs(acols)
    vec = all(t.data_ptr() % 16 == 0
              for c in pcols + acols for t in c[:2]) \
        and idx.data_ptr() % 16 == 0
    stride = CO.tree_node_stride(live_p2)
    part, ticket, nodes = CO._agg_scratch(dev, stride, rows)
    w = N_COUNTS + 4 * m
    res = torch.empty(rows * w * 8 + rows * live_p2, dtype=torch.uint8,
                      device=dev)
    out = res[:rows * w * 8].view(torch.int64)
    mask = res[rows * w * 8:]
    f = CO._fn("rt_chain",
               [CO._P, CO._P, CO._P, CO._P, CO._I, CO._P, CO._L, CO._P,
                CO._L, CO._I, CO._I, CO._L, CO._P, CO._I, CO._P, CO._I,
                CO._L, CO._I, CO._I, CO._I, CO._P, CO._P, CO._P, CO._P,
                CO._P, CO._P, CO._L, CO._P, CO._P, CO._P])
    # the stamp and the launches that write and read it, as one critical
    # section: another thread's scatter between this one's launches would
    # overwrite its flags
    with _ops.stream_lock(dev):
        flags, stamp, clear = _flag_buffer(dev, rows * nf * total_p2)
        rc = f(ctypes.cast(pos_arr, CO._P), ctypes.cast(width, CO._P),
               ctypes.cast(field, CO._P), ctypes.cast(is32, CO._P), nt,
               abo_p, max_len, flags.data_ptr(), clear, stamp, nf, total_p2,
               ctypes.cast(pd, CO._P), len(pcols), ctypes.cast(ad, CO._P), m,
               live_p2, rows, CO.agg_blocks(live_p2), int(vec),
               bounds_p if nb else None, idx.data_ptr(), nlive_p,
               part.data_ptr(), ticket.data_ptr(), nodes.data_ptr(), stride,
               out.data_ptr(), mask.data_ptr(), _ops.stream(idx))
    _ops.count(chain_cuda)
    _ops.count(chain_cuda, "clears", int(clear > 0))
    _ops.check(rc, "fused_index_chain")
    return res


chain_cuda.launches = 0     # dispatches (each one rt_chain call)
chain_cuda.clears = 0       # of them, those that zeroed the flags first


def fused_chain(tiers: Sequence[Sequence[torch.Tensor]], abo: np.ndarray,
                idx: torch.Tensor, n_live: np.ndarray, preds: Sequence,
                aggs: Sequence, total_p2: int, live_p2: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """A6 over R rows: the kernel for CUDA operands, the plain version for
    CPU ones (module docstring)."""
    args = (tiers, abo, idx, n_live, preds, aggs, total_p2, live_p2)
    if not idx.is_cuda:
        return chain_plain(*args)
    return unpack(chain_cuda(*args).cpu().numpy(), int(idx.shape[0]),
                  N_COUNTS + 4 * len(aggs), live_p2)


def split_raw(raw: np.ndarray, floats: Sequence[bool], n_counts: int
              ) -> Tuple[List[np.ndarray], List[Tuple[np.ndarray, ...]]]:
    """``raw`` [R, n_counts + 4 M] -> (the count columns, per aggregate
    column (sum, min, max, valid count) arrays over the rows, float64
    columns' sums, mins and maxes as float64)."""
    counts = [raw[:, c] for c in range(n_counts)]
    per_col = []
    for j, fl in enumerate(floats):
        base = n_counts + 4 * j
        vals = [np.ascontiguousarray(raw[:, base + f]) for f in (1, 2, 3)]
        if fl:
            vals = [v.view(np.float64) for v in vals]
        per_col.append((vals[0], vals[1], vals[2], raw[:, base]))
    return counts, per_col
