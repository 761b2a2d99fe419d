"""The partition runtime's kernels (``runtime/spmd``), on PyTorch with
hand-written CUDA kernels.

  range_mask_rows(...)        stacked K1 (``csrc/range_mask.cu`` with a
                              row axis): [R, n] columns, each row masked
                              against its own bounds
  filter_aggregate_rows(...)  stacked K2 (``csrc/filter_aggregate.cu``
                              with a row axis): each row's mask, survivor
                              count and per-column count / sum / min / max
  exchange_planes(...)        the hash exchange's all-to-all of [p, p, cap]
                              planes, which on one card is a swap of their
                              first two axes (``csrc/spmd_ops.cu``)
  merge_rows(...)             a [R, M] array of partials reduced over its
                              rows, left to right (``csrc/spmd_ops.cu``)

The reference runs each as one ``shard_map`` over its partition mesh
(``repro/runtime/spmd.py``: ``_mask_fn``, ``_agg_fn``, ``_exchange_fn``,
``_merge_fn``).  Every wrapper dispatches on the device of the tensors it
is handed: a CUDA tensor launches the kernel (or raises), a CPU tensor
runs the plain PyTorch version beside it.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import columnar_ops as CO
from . import ops as _ops
from .chain_ops import agg_slots_plain, bound_bits, unpack

__all__ = ["range_mask_rows", "range_mask_rows_plain",
           "range_mask_rows_cuda", "filter_aggregate_rows",
           "filter_aggregate_rows_plain", "filter_aggregate_rows_cuda",
           "exchange_planes", "exchange_plain", "exchange_cuda",
           "pack_planes", "merge_rows", "merge_plain", "merge_cuda"]

# a stacked predicate column: (data [R, n], valid [R, n], lo [R], hi [R])
# with numpy bounds in the data's dtype


def _rows_mask_plain(pcols: Sequence[Tuple], rows: int, n: int,
                     dev: torch.device) -> torch.Tensor:
    m = torch.ones((rows, n), dtype=torch.bool, device=dev)
    for x, v, lo, hi in pcols:
        lo_t = torch.from_numpy(np.asarray(lo)).to(dev)[:, None]
        hi_t = torch.from_numpy(np.asarray(hi)).to(dev)[:, None]
        m = m & v & (x >= lo_t) & (x <= hi_t)
    return m


def range_mask_rows_plain(pcols: Sequence[Tuple], rows: int, n: int
                          ) -> torch.Tensor:
    """Stacked K1's plain version: bool [R, n]."""
    return _rows_mask_plain(pcols, rows, n, pcols[0][0].device)


def _device_cols(cols: Sequence[Tuple]) -> List[Tuple]:
    return [(c[0], c[1], None, None) for c in cols]


def _bounds_dev(pcols: Sequence[Tuple], dev: torch.device) -> torch.Tensor:
    bb = bound_bits([c[2] for c in pcols], [c[3] for c in pcols])
    return torch.from_numpy(bb).to(dev)


def range_mask_rows_cuda(pcols: Sequence[Tuple], rows: int, n: int
                         ) -> torch.Tensor:
    """Stacked K1 on the card: one launch over every row (a pass per 8
    predicates), bool [R, n]."""
    dev = pcols[0][0].device
    out = torch.empty((rows, n), dtype=torch.bool, device=dev)
    bounds = _bounds_dev(pcols, dev)
    f = CO._fn("rt_range_mask_rows",
               [CO._P, CO._I, CO._L, CO._I, CO._P, CO._P, CO._P])
    rc = f(ctypes.cast(CO._descs(_device_cols(pcols)), CO._P), len(pcols),
           n, rows, bounds.data_ptr(), out.data_ptr(), _ops.stream(out))
    range_mask_rows_cuda.launches += 1
    _ops.check(rc, "range_mask (stacked)")
    return out


range_mask_rows_cuda.launches = 0


def range_mask_rows(pcols: Sequence[Tuple], rows: int, n: int
                    ) -> np.ndarray:
    """Stacked K1: bool [R, n] on the host."""
    run = range_mask_rows_cuda if pcols[0][0].is_cuda \
        else range_mask_rows_plain
    return run(pcols, rows, n).cpu().numpy()


def filter_aggregate_rows_plain(pcols: Sequence[Tuple],
                                acols: Sequence[Tuple], rows: int, n: int
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked K2's plain version: (raw int64 [R, 1 + 4 M], mask [R, n])
    in the kernel's layout (``chain_ops.split_raw`` with one count)."""
    mask = _rows_mask_plain(pcols, rows, n, pcols[0][0].device)
    raw = np.zeros((rows, 1 + 4 * len(acols)), dtype=np.int64)
    for r in range(rows):
        raw[r, 0] = int(mask[r].sum())
        raw[r, 1:] = agg_slots_plain(mask[r],
                                     [(d[r], v[r]) for d, v in acols])
    return raw, mask.cpu().numpy()


def filter_aggregate_rows_cuda(pcols: Sequence[Tuple],
                               acols: Sequence[Tuple], rows: int, n: int
                               ) -> torch.Tensor:
    """Stacked K2 on the card: one launch over every row (per 8 aggregate
    columns), each row folding into its own scratch and out row.  Returns
    the packed result on the card (``chain_ops.unpack``'s layout), which
    comes back in one copy."""
    if len(pcols) > CO._MAX_COLS:
        raise ValueError(f"stacked fused_filter_aggregate takes at most "
                         f"{CO._MAX_COLS} predicate columns, got "
                         f"{len(pcols)}")
    dev = pcols[0][0].device
    m = len(acols)
    pd = CO._descs(_device_cols(pcols))
    ad = CO._descs(_device_cols(acols))
    vec = all(t.data_ptr() % 16 == 0 for c in list(pcols) + list(acols)
              for t in c[:2])
    bounds = _bounds_dev(pcols, dev)
    stride = CO.tree_node_stride(n)
    part, ticket, nodes = CO._agg_scratch(dev, stride, rows)
    w = 1 + 4 * m
    res = torch.empty(rows * w * 8 + rows * n, dtype=torch.uint8, device=dev)
    out = res[:rows * w * 8].view(torch.int64)
    mask = res[rows * w * 8:]
    f = CO._fn("rt_filter_aggregate_rows",
               [CO._P, CO._I, CO._P, CO._I, CO._L, CO._I, CO._I, CO._I,
                CO._P, CO._P, CO._P, CO._P, CO._L, CO._P, CO._P, CO._P])
    rc = f(ctypes.cast(pd, CO._P), len(pcols), ctypes.cast(ad, CO._P), m, n,
           rows, CO.agg_blocks(n), int(vec), part.data_ptr(),
           ticket.data_ptr(), out.data_ptr(), nodes.data_ptr(), stride,
           bounds.data_ptr(), mask.data_ptr(), _ops.stream(out))
    filter_aggregate_rows_cuda.launches += 1
    _ops.check(rc, "fused_filter_aggregate (stacked)")
    return res


filter_aggregate_rows_cuda.launches = 0


def filter_aggregate_rows(pcols: Sequence[Tuple], acols: Sequence[Tuple],
                          rows: int, n: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked K2: (raw [R, 1 + 4 M], mask [R, n]) on the host."""
    if not pcols[0][0].is_cuda:
        return filter_aggregate_rows_plain(pcols, acols, rows, n)
    return unpack(filter_aggregate_rows_cuda(pcols, acols, rows, n).cpu()
                  .numpy(), rows, 1 + 4 * len(acols), n)


# ---------------------------------------------------------------------------
# the exchange: [p, p, cap] planes, packed into one byte buffer
# ---------------------------------------------------------------------------

def pack_planes(planes: Sequence[np.ndarray]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(bytes, meta): the planes back to back, each at a 16-byte aligned
    offset, and int64 [n_planes, 3] (offset, bytes of a (i, j) block,
    bytes of the alignment gap after the plane)."""
    meta = np.zeros((len(planes), 3), dtype=np.int64)
    off = 0
    for q, a in enumerate(planes):
        p = a.shape[0]
        size = -(-a.nbytes // 16) * 16
        meta[q] = off, a.nbytes // (p * p), size - a.nbytes
        off += size
    buf = np.zeros(off, dtype=np.uint8)
    for q, a in enumerate(planes):
        o = int(meta[q, 0])
        buf[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    return buf, meta


def exchange_plain(send: torch.Tensor, meta: np.ndarray, p: int
                   ) -> torch.Tensor:
    """The exchange's plain version: every plane's (i, j) block to (j, i)."""
    recv = torch.zeros_like(send)
    for off, blk, _gap in meta.tolist():
        n = p * p * blk
        src = send[off:off + n].view(p, p, blk)
        recv[off:off + n].view(p, p, blk).copy_(src.transpose(0, 1))
    return recv


def exchange_cuda(send: torch.Tensor, meta: np.ndarray, p: int
                  ) -> torch.Tensor:
    """The exchange on the card: one launch over every plane."""
    recv = torch.empty_like(send)
    meta_d = torch.from_numpy(np.ascontiguousarray(meta)).to(send.device)
    f = CO._fn("rt_exchange_planes",
               [CO._P, CO._P, CO._P, CO._I, CO._I, CO._P])
    rc = f(send.data_ptr(), recv.data_ptr(), meta_d.data_ptr(),
           int(meta.shape[0]), p, _ops.stream(send))
    exchange_cuda.launches += 1
    _ops.check(rc, "spmd_exchange")
    return recv


exchange_cuda.launches = 0


def exchange_planes(planes: Sequence[np.ndarray], p: int
                    ) -> List[np.ndarray]:
    """All-to-all of [p, p, cap] planes on one device: ``recv[j, i] =
    send[i, j]`` for every plane, in one launch on the card."""
    buf, meta = pack_planes(planes)
    send = torch.from_numpy(buf).to(_ops.target())
    run = exchange_cuda if send.is_cuda else exchange_plain
    host = run(send, meta, p).cpu().numpy()
    out = []
    for a, (off, _blk, _gap) in zip(planes, meta.tolist()):
        out.append(host[off:off + a.nbytes].view(a.dtype).reshape(a.shape))
    return out


# ---------------------------------------------------------------------------
# merges: [R, M] -> [M], left to right over the rows
# ---------------------------------------------------------------------------

_MERGE_OPS = {"sum": 0, "min": 1, "max": 2}
_MERGE_DT = {torch.int64: 0, torch.float64: 1, torch.int32: 2,
             torch.float32: 3}


def merge_plain(x: torch.Tensor, op: str) -> torch.Tensor:
    """The merges' plain version: row 0, then each row folded in order
    (``torch.minimum`` / ``maximum`` propagate NaN, as numpy's do)."""
    fold = {"sum": torch.add, "min": torch.minimum,
            "max": torch.maximum}[op]
    acc = x[0].clone()
    for r in range(1, x.shape[0]):
        acc = fold(acc, x[r])
    return acc


def merge_cuda(x: torch.Tensor, op: str) -> torch.Tensor:
    """A merge on the card: one launch, a thread a column."""
    if not (x.is_cuda and x.dim() == 2 and x.is_contiguous()
            and x.dtype in _MERGE_DT):
        raise TypeError("spmd merge: a contiguous CUDA [rows, M] int32, "
                        "int64, float32 or float64 array expected")
    out = torch.empty(x.shape[1], dtype=x.dtype, device=x.device)
    f = CO._fn("rt_merge_rows", [CO._P, CO._L, CO._L, CO._I, CO._I, CO._P,
                                 CO._P])
    rc = f(x.data_ptr(), x.shape[0], x.shape[1], _MERGE_DT[x.dtype],
           _MERGE_OPS[op], out.data_ptr(), _ops.stream(x))
    merge_cuda.launches += 1
    _ops.check(rc, f"spmd_merge_{op}")
    return out


merge_cuda.launches = 0


def merge_rows(parts: np.ndarray, op: str) -> np.ndarray:
    """``parts`` [R, M] reduced over its rows (``op``: sum, min, max)."""
    x = torch.from_numpy(np.ascontiguousarray(parts)).to(_ops.target())
    run = merge_cuda if x.is_cuda else merge_plain
    return run(x, op).cpu().numpy()
