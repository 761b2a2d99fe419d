"""The partition runtime's kernels (``runtime/spmd``), on PyTorch with
hand-written CUDA kernels.

  range_mask_rows(...)        stacked K1 (``csrc/range_mask.cu`` with a
                              row axis): [R, n] columns, each row masked
                              against its own bounds
  filter_aggregate_rows(...)  stacked K2 (``csrc/filter_aggregate.cu``
                              with a row axis): each row's mask, survivor
                              count and per-column count / sum / min / max
  stage_exchange(...),        the hash exchange: the sources' rows sent as
  exchange_cuda(...)          they are, partitioned on the card by a
                              stable counting sort on their partition ids
                              (``csrc/spmd_ops.cu``)
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
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import columnar_ops as CO
from . import ops as _ops
from .chain_ops import agg_slots_plain, unpack
from .columnar_ops import range_mask_rows_cuda, range_mask_rows_plain

__all__ = ["range_mask_rows", "range_mask_rows_plain",
           "range_mask_rows_cuda", "filter_aggregate_rows",
           "filter_aggregate_rows_plain", "filter_aggregate_rows_cuda",
           "ExchangeLayout", "exchange_layout", "stage_exchange", "download",
           "exchange_plain", "exchange_cuda", "received", "EXCHANGE_MAX_P", "merge_rows", "merge_plain", "merge_cuda"]

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
    mask = range_mask_rows_plain(pcols, rows, n)
    raw = np.zeros((rows, 1 + 4 * len(acols)), dtype=np.int64)
    for r in range(rows):
        raw[r, 0] = int(mask[r].sum())
        raw[r, 1:] = agg_slots_plain(mask[r],
                                     [(d[r], v[r]) for d, v in acols])
    return raw, mask.cpu().numpy()


# per (device, stream): stacked K2's tickets on its groups of 32 float64
# node sums, uint32 [rows, stride], zeros between launches (the kernel
# leaves them 0; grown to the most rows and groups seen)
_GROUP_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _group_tickets(dev: torch.device, rows: int, stride: int
                   ) -> torch.Tensor:
    key = _ops.stream_key(dev)
    with CO.SCRATCH_LOCK:
        got = _GROUP_TICKETS.get(key)
        if got is None or got.numel() < rows * stride:
            got = _GROUP_TICKETS[key] = torch.zeros(rows * stride,
                                                    dtype=torch.int32,
                                                    device=dev)
    return got


def filter_aggregate_rows_cuda(pcols: Sequence[Tuple],
                               acols: Sequence[Tuple], rows: int, n: int
                               ) -> torch.Tensor:
    """Stacked K2 on the card: one launch over every row (per 8 aggregate
    columns), each row folding into its own scratch and out row
    (``csrc/filter_aggregate.cu``: rows_agg_kernel, a grid of about one
    wave streaming its chunks through shared memory, where every operand
    is 16-byte aligned and n a multiple of 16; else the first design).
    Returns the packed result on the card (``chain_ops.unpack``'s layout),
    which comes back in one copy.  More than 8 predicate columns add one
    stacked K1 launch first (``columnar_ops.fold_extra_preds``).  Launches
    that took the first design are also counted in ``launches_first``."""
    pcols = CO.fold_extra_preds(
        pcols, lambda cols: range_mask_rows_cuda(cols, rows, n))
    dev = pcols[0][0].device
    m = len(acols)
    pd = CO._descs(CO.device_cols(pcols))
    ad = CO._descs(CO.device_cols(acols))
    vec = all(t.data_ptr() % 16 == 0 for c in list(pcols) + list(acols)
              for t in c[:2])
    bounds = CO.bounds_dev(pcols, dev)
    stride = CO.tree_node_stride(n)
    part, ticket, nodes = CO._agg_scratch(dev, stride, rows)
    # a ticket a group of 32 node sums at every level: fewer than the
    # nodes of all levels
    gticket = _group_tickets(dev, rows, stride)
    w = 1 + 4 * m
    res = torch.empty(rows * w * 8 + rows * n, dtype=torch.uint8, device=dev)
    out = res[:rows * w * 8].view(torch.int64)
    mask = res[rows * w * 8:]
    f = CO._fn("rt_filter_aggregate_rows",
               [CO._P, CO._I, CO._P, CO._I, CO._L, CO._I, CO._I, CO._I,
                CO._P, CO._P, CO._P, CO._L, CO._P, CO._P, CO._L, CO._P,
                CO._P, CO._P])
    rc = f(ctypes.cast(pd, CO._P), len(pcols), ctypes.cast(ad, CO._P), m, n,
           rows, CO.agg_blocks(n), int(vec), part.data_ptr(),
           ticket.data_ptr(), gticket.data_ptr(), stride, out.data_ptr(),
           nodes.data_ptr(), stride, bounds.data_ptr(), mask.data_ptr(),
           _ops.stream(out))
    _ops.count(filter_aggregate_rows_cuda)
    _ops.count(filter_aggregate_rows_cuda, "launches_first",
               int(not vec or n % 16))
    _ops.check(rc, "fused_filter_aggregate (stacked)")
    return res


filter_aggregate_rows_cuda.launches = 0
filter_aggregate_rows_cuda.launches_first = 0


def filter_aggregate_rows(pcols: Sequence[Tuple], acols: Sequence[Tuple],
                          rows: int, n: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked K2: (raw [R, 1 + 4 M], mask [R, n]) on the host."""
    if not pcols[0][0].is_cuda:
        return filter_aggregate_rows_plain(pcols, acols, rows, n)
    return unpack(filter_aggregate_rows_cuda(pcols, acols, rows, n).cpu()
                  .numpy(), rows, 1 + 4 * len(acols), n)


# ---------------------------------------------------------------------------
# the exchange: a stable partition of the sources' rows by partition id
# ---------------------------------------------------------------------------

XK_I64, XK_U8, XK_PID = 0, 1, 2          # csrc/spmd_ops.cu key kinds
# partitions the card's counters hold (p + 1 int64 slots a warp, in 48 KB
# of shared memory with one warp a block at the most)
EXCHANGE_MAX_P = 4096
# storage/dataset.hash_partition_array's multiplier, as an int64 whose
# wrapping product has the same bits as the uint64 one
_HASH_MUL = 11400714819323198485 - (1 << 64)
_SMEM = 48 * 1024


def _a16(x: int) -> int:
    return -(-x // 16) * 16


class ExchangeLayout(NamedTuple):
    """Where an exchange's operands sit in its two byte buffers.

    send: the header (int64: ``src_rows`` [p + 1], the first tile of each
    source [p + 1], a column table [C, 3]), then at ``head`` the column
    area: a column's data (n elements) and validity (n bytes), each at a
    16-byte aligned offset, the sources' rows back to back; then, where
    the host computed them, the int32 partition ids.  recv: the counts
    [p, p] (int64, rows of source i bound for j), then at ``recv_head``
    the received column area, the same offsets holding the rows
    dest-major."""
    p: int
    n: int
    src_rows: np.ndarray                  # int64 [p + 1]
    tile0: np.ndarray                     # int64 [p + 1] first tiles
    cols: Tuple[Tuple[np.dtype, int, int], ...]   # dtype, data, validity
    key_kind: int
    key_off: int
    head: int
    area: int                             # bytes sent after head
    out_area: int                         # bytes received after recv_head
    recv_head: int
    warps: int                            # a block's; 128 rows a warp

    @property
    def send_bytes(self) -> int:
        return self.head + self.area

    @property
    def recv_bytes(self) -> int:
        return self.recv_head + self.out_area

    @property
    def ntiles(self) -> int:
        return int(self.tile0[-1])


def exchange_layout(rows: Sequence[int], dtypes: Sequence[np.dtype],
                    key: Optional[int], p: int) -> ExchangeLayout:
    """The layout of an exchange of ``rows[i]`` rows from each source with
    columns of ``dtypes`` (8- or 1-byte elements); ``key``: the column
    hashed on the card, or None for host partition ids."""
    if len(rows) != p or not 1 <= p <= EXCHANGE_MAX_P:
        raise ValueError(f"an exchange of {len(rows)} sources over {p} "
                         f"partitions (1 .. {EXCHANGE_MAX_P})")
    src_rows = np.zeros(p + 1, np.int64)
    src_rows[1:] = np.cumsum(rows)
    n = int(src_rows[-1])
    # a block's tile: its warps' runs of 128 rows (csrc XW_ROWS), as many
    # warps as p + 1 int64 counters each fit in 48 KB, at most 8
    warps = max(1, min(8, _SMEM // (8 * (p + 1))))
    tile_rows = 128 * warps
    cols, off = [], 0
    for dt in dtypes:
        dt = np.dtype(dt)
        if dt.itemsize not in (1, 8):
            raise TypeError(f"exchange: {dt} columns have no kernel")
        d = off
        off += _a16(n * dt.itemsize)
        cols.append((dt, d, off))
        off += _a16(n)
    out_area = off
    if key is None:
        key_kind, key_off = XK_PID, off
        off += _a16(4 * n)
    else:
        dt, key_off, _v = cols[key]
        key_kind = XK_I64 if dt.itemsize == 8 else XK_U8
    tile0 = np.zeros(p + 1, np.int64)
    tile0[1:] = np.cumsum([-(-r // tile_rows) for r in rows])
    return ExchangeLayout(
        p, n, src_rows, tile0, tuple(cols), key_kind, key_off,
        _a16(8 * (2 * (p + 1) + 3 * len(cols))), off, out_area,
        _a16(8 * p * p), warps)


def stage_exchange(cols: Sequence[Sequence[Tuple[np.ndarray, np.ndarray]]],
                   rows: Sequence[int], key: Any, p: int
                   ) -> Tuple[torch.Tensor, ExchangeLayout]:
    """The send buffer of an exchange, filled on the host: ``cols[c][i]``
    is source i's (data, validity) of column c (``rows[i]`` rows), ``key``
    the index of the column the card hashes, or a list of each source's
    partition ids.  Pinned when the operands go to a card, so it goes up
    in one asynchronous copy."""
    lay = exchange_layout(rows, [c[0][0].dtype for c in cols],
                          key if isinstance(key, int) else None, p)
    pinned = _ops.target().type == "cuda"
    buf = torch.empty(lay.send_bytes, dtype=torch.uint8,
                      pin_memory=pinned)
    host = buf.numpy()
    meta = [lay.src_rows, lay.tile0]
    meta += [np.asarray([dt.itemsize, d, v], np.int64)
             for dt, d, v in lay.cols]
    head = np.concatenate(meta)
    host[:head.nbytes] = head.view(np.uint8)
    area = host[lay.head:]
    r = lay.src_rows
    for (dt, doff, voff), per in zip(lay.cols, cols):
        data = area[doff:doff + lay.n * dt.itemsize].view(dt)
        valid = area[voff:voff + lay.n].view(np.bool_)
        for i, (d, v) in enumerate(per):
            np.copyto(data[r[i]:r[i + 1]], d[:rows[i]])
            np.copyto(valid[r[i]:r[i + 1]], v[:rows[i]])
    if lay.key_kind == XK_PID:
        ids = area[lay.key_off:lay.key_off + 4 * lay.n].view(np.int32)
        for i, pid in enumerate(key):
            np.copyto(ids[r[i]:r[i + 1]], pid[:rows[i]], casting="unsafe")
    return buf, lay


def download(recv: torch.Tensor) -> np.ndarray:
    """A device buffer back to the host in one copy (into pinned memory
    from PyTorch's caching host allocator), as numpy."""
    if not recv.is_cuda:
        return recv.numpy()
    host = torch.empty(recv.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(recv, non_blocking=True)
    torch.cuda.current_stream(recv.device).synchronize()
    return host.numpy()


def _elem_view(b: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    return b.view(torch.int64 if dt.itemsize == 8 else torch.uint8)


def exchange_plain(send: torch.Tensor, lay: ExchangeLayout) -> torch.Tensor:
    """The exchange's plain version on ``send``'s device: the partition
    ids (the hash in wrapping int64 arithmetic, or the host's), a stable
    argsort of them and a gather of every column, and the counts."""
    dev, n, p = send.device, lay.n, lay.p
    area = send[lay.head:lay.head + lay.area]
    if lay.key_kind == XK_PID:
        pid = area[lay.key_off:lay.key_off + 4 * n].view(
            torch.int32).to(torch.int64)
    else:
        es = 8 if lay.key_kind == XK_I64 else 1
        k = area[lay.key_off:lay.key_off + es * n]
        k = k.view(torch.int64) if es == 8 else k.to(torch.int64)
        pid = (((k * _HASH_MUL) >> 40) & 0xFFFFFF) % p
    order = torch.argsort(pid, stable=True)
    src = torch.repeat_interleave(
        torch.arange(p, device=dev),
        torch.from_numpy(np.diff(lay.src_rows)).to(dev))
    recv = torch.empty(lay.recv_bytes, dtype=torch.uint8, device=dev)
    recv[:8 * p * p].view(torch.int64).copy_(
        torch.bincount(src * p + pid, minlength=p * p))
    out = recv[lay.recv_head:]
    for dt, doff, voff in lay.cols:
        nb = n * dt.itemsize
        _elem_view(out[doff:doff + nb], dt).copy_(
            _elem_view(area[doff:doff + nb], dt)[order])
        out[voff:voff + n].copy_(area[voff:voff + n][order])
    return recv


def exchange_cuda(send: torch.Tensor, lay: ExchangeLayout) -> torch.Tensor:
    """The exchange on the card, one C call of three launches (histogram,
    scan, scatter; ``csrc/spmd_ops.cu``)."""
    if not (send.is_cuda and send.dtype == torch.uint8
            and send.is_contiguous() and send.numel() == lay.send_bytes
            and send.data_ptr() % 16 == 0):
        raise TypeError("spmd exchange: a contiguous, 16-byte aligned CUDA "
                        "uint8 send buffer of the layout's size expected")
    dev = send.device
    recv = torch.empty(lay.recv_bytes, dtype=torch.uint8, device=dev)
    cells = lay.p * lay.ntiles
    hist = torch.empty(cells, dtype=torch.int32, device=dev)
    offs = torch.empty(cells + 1, dtype=torch.int64, device=dev)
    f = CO._fn("rt_exchange",
               [CO._P, CO._L, CO._I, CO._L, CO._I, CO._I, CO._L, CO._L,
                CO._I, CO._P, CO._L, CO._P, CO._P, CO._P])
    rc = f(send.data_ptr(), lay.head, lay.p, lay.n, len(lay.cols),
           lay.key_kind, lay.key_off, lay.ntiles, lay.warps,
           recv.data_ptr(), lay.recv_head, hist.data_ptr(), offs.data_ptr(),
           _ops.stream(send))
    _ops.count(exchange_cuda)
    _ops.check(rc, "spmd_exchange")
    return recv


exchange_cuda.launches = 0


def received(host: np.ndarray, lay: ExchangeLayout
             ) -> Tuple[np.ndarray, List[Tuple[np.ndarray, np.ndarray]]]:
    """(counts [p, p], each column's (data, validity) over all ``n`` rows,
    dest-major): views of a received buffer on the host."""
    counts = host[:8 * lay.p * lay.p].view(np.int64).reshape(lay.p, lay.p)
    area = host[lay.recv_head:]
    return counts, [(area[d:d + lay.n * dt.itemsize].view(dt),
                     area[v:v + lay.n].view(np.bool_))
                    for dt, d, v in lay.cols]


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
    _ops.count(merge_cuda)
    _ops.check(rc, f"spmd_merge_{op}")
    return out


merge_cuda.launches = 0


def merge_rows(parts: np.ndarray, op: str) -> np.ndarray:
    """``parts`` [R, M] reduced over its rows (``op``: sum, min, max)."""
    x = torch.from_numpy(np.ascontiguousarray(parts)).to(_ops.target())
    run = merge_cuda if x.is_cuda else merge_plain
    return run(x, op).cpu().numpy()
