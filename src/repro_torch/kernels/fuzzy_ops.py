"""Similarity kernels for the fuzzy query subsystem, numpy in / numpy
out with the reference's signatures (``repro/kernels/fuzzy_ops.py``):

  fnv1a_hash(tokens)             vectorized FNV-1a-64 over a padded byte
                                 matrix (pure numpy, copied as is)
  t_occurrence_mask(pos, n, T)   K4: posting-position hits -> bool bitmap
                                 of rows with >= T hits; at T = 1 this is
                                 every secondary-index candidate bitmap,
                                 at T > 1 the ngram probe (its segments
                                 sorted, counted a row tile at a time)
  edit_distances(strs, q, d)     K5: min(levenshtein(s, q), d + 1) per
                                 candidate string (bit-parallel on the
                                 card up to a 64-character query)
  set_intersect_counts(a, b)     K6: |a_i & b_i| per pair of sorted,
                                 dictionary-coded sets (``_padded`` for
                                 callers holding one padded record matrix)
  bitset_intersect_counts(...)   A7: popcount(bits[a] & bits[b]) per pair
                                 of vocabulary bitsets (``encode_bitsets``
                                 builds them, pure numpy)
  jaccard_sims / jaccard_from_counts   float64 Jaccard from exact counts

``positions`` is either one host array of row positions (the reference's
signature) or a list of :class:`Segment` s — slices of immutable posting
arrays plus a row offset, marked ``sorted`` where the caller knows the
slice's positions ascend.  Segment arrays go through the device pool, so
an index probe over resident postings ships nothing host -> device.

Every kernel wrapper dispatches on the device of its pooled operands: a
CUDA tensor launches the kernel from ``csrc/`` (or raises), a CPU tensor
runs the plain PyTorch version beside it.  On the card the kernel always
launches, whatever the batch size (the reference's small-batch host
shortcuts are not carried over).  Results are exact integers in every
route; Jaccard divides on the host in float64, so similarities equal the
reference's bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import device_pool as _pool
from . import ops as _ops
from .columnar_ops import note_shape
from ..obs import record_dispatch as _record_dispatch
from ..columnar.batch import pow2_len as _pow2_len

__all__ = ["fnv1a_hash", "t_occurrence_mask", "Segment", "DevSeg",
           "tocc_plain",
           "tocc_cuda", "edit_distances", "ed_plain", "ed_cuda",
           "set_intersect_counts", "set_intersect_counts_padded",
           "inter_plain", "inter_cuda", "encode_bitsets",
           "bitset_intersect_counts", "popcount_plain", "popcount_cuda",
           "jaccard_from_counts", "jaccard_sims"]

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _fn(name: str, argtypes: Sequence[Any]) -> Any:
    f = getattr(_ops.lib(), name)
    f.restype = ctypes.c_int
    f.argtypes = list(argtypes)
    return f


# ---------------------------------------------------------------------------
# FNV-1a token hashing (vectorized over a padded byte matrix)
# ---------------------------------------------------------------------------

def fnv1a_hash(tokens: Sequence[str]) -> np.ndarray:
    """64-bit FNV-1a of each token, bit-identical to the classic per-byte
    loop: tokens are laid out as one [T, Lmax] byte matrix and the hash
    state advances one *column* (not one token) at a time, so the
    python-level work is O(max token length), not O(total bytes)."""
    n = len(tokens)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    bs = [t.encode() for t in tokens]
    lens = np.fromiter((len(b) for b in bs), dtype=np.int64, count=n)
    lmax = int(lens.max()) if n else 0
    mat = np.zeros((n, max(lmax, 1)), dtype=np.uint64)
    for i, b in enumerate(bs):
        if b:
            mat[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    h = np.full(n, _FNV_OFFSET, dtype=np.uint64)
    for j in range(lmax):
        live = j < lens
        hj = (h ^ mat[:, j]) * _FNV_PRIME          # uint64 wrap == mod 2**64
        h = np.where(live, hj, h)
    return h


# ---------------------------------------------------------------------------
# K4: T-occurrence count (secondary and ngram candidate generation)
# ---------------------------------------------------------------------------

class Segment(NamedTuple):
    """``positions[start:stop] + offset``: one tier's posting slice.
    ``sorted``: the slice's positions are non-decreasing (set only by
    callers that know it; K4 at T > 1 then counts a row tile at a time)."""
    positions: np.ndarray
    start: int
    stop: int
    offset: int
    sorted: bool = False


class DevSeg(NamedTuple):
    """A segment on the device: ``pos[start:start + count] + offset``;
    a sorted one carries its first and last position (host values), from
    which the kernel interpolates where a row falls."""
    pos: torch.Tensor
    start: int
    count: int
    offset: int
    sorted: bool = False
    first: int = 0
    last: int = 0


def tocc_plain(segs: Sequence[DevSeg], n: int, n_out: int,
               threshold: int) -> torch.Tensor:
    """K4's plain version: bool [n_out], rows < n with >= T hits."""
    dev = segs[0].pos.device
    pos = torch.cat([s.pos[s.start:s.start + s.count] + s.offset
                     for s in segs])
    pos = pos[(pos >= 0) & (pos < n)]
    out = torch.zeros(n_out, dtype=torch.bool, device=dev)
    if threshold == 1:
        out[pos] = True
    else:
        out[:n] = torch.bincount(pos, minlength=n) >= threshold
    return out


class SegDesc(ctypes.Structure):
    """Mirror of ``struct SegDesc`` in csrc/t_occurrence.cu."""
    _fields_ = [("pos", ctypes.c_void_p), ("start", ctypes.c_int64),
                ("count", ctypes.c_int64), ("offset", ctypes.c_int64)]


class SortedSeg(ctypes.Structure):
    """Mirror of ``struct SortedSeg`` in csrc/t_occurrence.cu."""
    _fields_ = [("pos", ctypes.c_void_p), ("count", ctypes.c_int64),
                ("offset", ctypes.c_int64), ("first", ctypes.c_int64),
                ("slope", ctypes.c_double)]


# csrc/t_occurrence.cu: segments the sorted kernel takes in its parameters
# (a longer table is copied to the device)
_TOCC_PARAM_SEGS = 96


def _sorted_table(segs: Sequence[DevSeg]) -> ctypes.Array:
    descs = (SortedSeg * len(segs))()
    for d, s in zip(descs, segs):
        d.pos = s.pos.data_ptr() + 8 * s.start
        d.count, d.offset, d.first = s.count, s.offset, s.first
        d.slope = (s.count - 1) / (s.last - s.first) \
            if s.last > s.first else 0.0
    return descs


def tocc_cuda(segs: Sequence[DevSeg], n: int, n_out: int, threshold: int,
              shipped: Optional[List[np.ndarray]] = None) -> torch.Tensor:
    """K4 on the card: bool [n_out].  At T > 1 over segments all marked
    sorted, one launch of the row-tile kernel (``launches_sorted``); else
    the scatter kernel.  A table of more than ``_TOCC_PARAM_SEGS`` sorted
    segments is copied to the device, and its bytes are appended to
    ``shipped``."""
    dev = segs[0].pos.device
    for s in segs:
        if not (s.pos.is_cuda and s.pos.dtype == torch.int64
                and s.pos.is_contiguous()):
            raise TypeError("t_occurrence_mask: contiguous CUDA int64 "
                            "positions expected")
    out = torch.empty(n_out, dtype=torch.bool, device=dev)
    if threshold > 1 and all(s.sorted for s in segs):
        if out.data_ptr() % 16:
            raise TypeError("t_occurrence_mask: 16-byte aligned output "
                            "expected")
        descs = _sorted_table(segs)
        ext = None
        if len(segs) > _TOCC_PARAM_SEGS:
            table = np.frombuffer(descs, dtype=np.uint8)
            ext = torch.from_numpy(table.copy()).to(dev)
            if shipped is not None:
                shipped.append(table)
        f = _fn("rt_t_occurrence_sorted", [_P, _I, _L, _L, _I, _P, _P, _P])
        rc = f(ctypes.cast(descs, ctypes.c_void_p), len(segs), n, n_out,
               threshold, None if ext is None else ext.data_ptr(),
               out.data_ptr(), _ops.stream(out))
        _ops.count(tocc_cuda, "launches_sorted")
    else:
        descs = (SegDesc * len(segs))()
        for d, s in zip(descs, segs):
            d.pos, d.start = s.pos.data_ptr(), s.start
            d.count, d.offset = s.count, s.offset
        counts = torch.empty(n + 1 if threshold > 1 else 1,
                             dtype=torch.int32, device=dev)
        f = _fn("rt_t_occurrence", [_P, _I, _L, _L, _I, _P, _P, _P])
        rc = f(ctypes.cast(descs, ctypes.c_void_p), len(segs), n, n_out,
               threshold, counts.data_ptr(), out.data_ptr(),
               _ops.stream(out))
    _ops.count(tocc_cuda)
    _ops.count(tocc_cuda, "launches_t1", int(threshold == 1))
    _ops.check(rc, "t_occurrence_mask")
    return out


tocc_cuda.launches = 0
tocc_cuda.launches_t1 = 0           # of them at T = 1 (the columnar probes)
tocc_cuda.launches_sorted = 0       # of them by the row-tile kernel


def t_occurrence_mask(positions: Union[np.ndarray, List[Segment]], n: int,
                      threshold: int) -> np.ndarray:
    """Bool [n]: rows whose hit count over ``positions`` reaches
    ``threshold``.

    ``positions`` is the concatenation of the probe's posting segments
    (one entry per (key, row) hit), as one host array or as a list of
    :class:`Segment` s over resident posting arrays.
    """
    if n == 0:
        return np.zeros(0, dtype=bool)
    if threshold <= 0:
        return np.ones(n, dtype=bool)
    if not isinstance(positions, list):
        arr = np.asarray(positions, dtype=np.int64)
        positions = [Segment(arr, 0, int(arr.shape[0]), 0)]
    segs = [s for s in positions if s.stop > s.start]
    m = sum(s.stop - s.start for s in segs)
    if m == 0:
        return np.zeros(n, dtype=bool)
    host = [s.positions if s.positions.dtype == np.int64
            else s.positions.astype(np.int64) for s in segs]
    ops, missed = _pool.fetch(host)
    dsegs = [DevSeg(t, int(s.start), int(s.stop - s.start), int(s.offset),
                    bool(s.sorted), int(h[s.start]), int(h[s.stop - 1]))
             for t, h, s in zip(ops, host, segs)]
    np2 = _pow2_len(n)
    # (n, m, T, segments): chip_smoke.py prints the keys the path met
    note_shape("t_occurrence_mask", np2, _pow2_len(m), threshold, len(segs))
    if ops[0].is_cuda:
        out_t = tocc_cuda(dsegs, n, np2, threshold, shipped=missed)
    else:
        out_t = tocc_plain(dsegs, n, np2, threshold)
    out = out_t.cpu().numpy()
    _record_dispatch("t_occurrence_mask", h2d=missed, d2h=[out])
    return out[:n]


# ---------------------------------------------------------------------------
# K5: saturating edit distance (candidate verification)
# ---------------------------------------------------------------------------

_ED_BITS = 64            # csrc/edit_distance.cu ED_BITS: the longest query
                         # the bit-parallel kernel takes


def _code_points(strings: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(int32 code points of all strings concatenated, int64 lengths):
    ``ord`` of every character, never UTF-8 bytes, from one UTF-32
    encode of the joined strings."""
    lens = np.fromiter(map(len, strings), np.int64, count=len(strings))
    flat = "".join(strings).encode("utf-32-le", "surrogatepass")
    return np.frombuffer(flat, dtype="<u4").astype(np.int32), lens


def _char_matrix(strings: Sequence[str], rows: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(int32 [rows, Lp] code-point matrix, int64 [rows] lengths), Lp the
    pow2 of the longest string; rows past ``len(strings)`` are empty."""
    codes, lens = _code_points(strings)
    B = len(strings)
    lp = _pow2_len(max(int(lens.max()) if B else 0, 1))
    mat = np.zeros((rows, lp), dtype=np.int32)
    if codes.shape[0]:
        starts = np.cumsum(lens) - lens
        r = np.repeat(np.arange(B, dtype=np.int64), lens)
        c = np.arange(codes.shape[0], dtype=np.int64) - np.repeat(starts,
                                                                  lens)
        mat[r, c] = codes
    lpad = np.zeros(rows, dtype=np.int64)
    lpad[:B] = lens
    return mat, lpad


def ed_plain(cand: torch.Tensor, lens: torch.Tensor, q: torch.Tensor,
             m: int, cap: int) -> torch.Tensor:
    """K5's plain version: int64 [B], the reference's row-at-a-time DP
    (``_ed_core``): one dense [B, L+1] step per query character, the
    in-row recurrence as a cumulative min of ``m[j] - j``."""
    B, L = cand.shape
    dev = cand.device
    j = torch.arange(L + 1, dtype=torch.int64, device=dev)
    dp = torch.clamp(j, max=cap).expand(B, L + 1)
    for i in range(m):
        sub = (cand != q[i:i + 1]).to(torch.int64)
        mm = torch.cat([torch.full((B, 1), i + 1, dtype=torch.int64,
                                   device=dev),
                        torch.minimum(dp[:, 1:] + 1, dp[:, :-1] + sub)], 1)
        t = torch.cummin(mm - j, dim=1).values
        dp = torch.clamp(t + j, max=cap)
    pick = torch.clamp(lens, max=L)
    return dp.gather(1, pick[:, None]).squeeze(1)


def ed_cuda(cand: torch.Tensor, lens: torch.Tensor, q: torch.Tensor,
            m: int, cap: int) -> torch.Tensor:
    """K5 on the card: int64 [B]; bit-parallel up to a 64-character
    query, the saturating DP (with a scratch row a candidate) beyond."""
    if not (cand.is_cuda and lens.is_cuda and q.is_cuda
            and cand.dtype == torch.int32 and cand.dim() == 2
            and cand.is_contiguous() and lens.dtype == torch.int64
            and lens.is_contiguous() and lens.shape[0] == cand.shape[0]
            and q.dtype == torch.int32 and q.shape[0] >= m):
        raise TypeError("ed_cuda: contiguous CUDA int32 [B, L] code points, "
                        "int64 [B] lengths and an int32 query expected")
    B, lp = cand.shape
    out = torch.empty(B, dtype=torch.int64, device=cand.device)
    scratch = torch.empty((m + 1) * B, dtype=torch.int32,
                          device=cand.device) if m > _ED_BITS else None
    vec = lp % 4 == 0 and cand.data_ptr() % 16 == 0
    f = _fn("rt_edit_distance",
            [_P, _P, _L, _L, _P, _I, _I, _I, _P, _P, _P])
    rc = f(cand.data_ptr(), lens.data_ptr(), B, lp, q.data_ptr(), m, cap,
           int(vec), None if scratch is None else scratch.data_ptr(),
           out.data_ptr(), _ops.stream(out))
    _ops.count(ed_cuda)
    _ops.check(rc, "edit_distances")
    return out


ed_cuda.launches = 0


def edit_distances(strings: Sequence[str], query: str, d: int
                   ) -> np.ndarray:
    """``min(edit_distance(s, query), d+1)`` per candidate: saturated
    (banded) distances whose ``<= d`` decision is exact, over code points
    (``ord``), so non-ASCII strings compare as in the reference."""
    B = len(strings)
    if B == 0:
        return np.zeros(0, dtype=np.int64)
    d = max(int(d), 0)
    bp = _pow2_len(B)
    cand, lens = _char_matrix(strings, bp)
    qcodes, _ = _code_points([query])
    m = int(qcodes.shape[0])
    mp = _pow2_len(max(m, 1))
    q = np.zeros(mp, dtype=np.int32)
    q[:m] = qcodes
    # no answer exceeds max(L, m), so a wider band changes nothing: the
    # cap stays in int32 for any d
    cap = min(d + 1, cand.shape[1] + m + 1)
    ops, missed = _pool.fetch([cand, lens, q])
    note_shape("edit_distances", bp, cand.shape[1], mp)
    if ops[0].is_cuda:
        out_t = ed_cuda(ops[0], ops[1], ops[2], m, cap)
    else:
        out_t = ed_plain(ops[0], ops[1], ops[2], m, cap)
    out = out_t.cpu().numpy()
    _record_dispatch("edit_distances", h2d=missed, d2h=[out])
    return out[:B]


# ---------------------------------------------------------------------------
# K6: batched sorted-set intersection (Jaccard verification)
# ---------------------------------------------------------------------------

_SENTINEL = np.int64(np.iinfo(np.int64).max)


def inter_plain(a: torch.Tensor, alens: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """K6's plain version: int64 [P], a batched binary search of each
    live a element in its sorted b row (the reference's ``_inter_core``)."""
    s1, s2 = a.shape[1], b.shape[1]
    pos = torch.searchsorted(b, a)
    hit = b.gather(1, pos.clamp(max=s2 - 1)) == a
    live = torch.arange(s1, device=a.device)[None, :] < alens[:, None]
    return (hit & live).sum(1)


def inter_cuda(a: torch.Tensor, alens: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """K6 on the card: int64 [P]."""
    if not (a.is_cuda and b.is_cuda and alens.is_cuda
            and a.dtype == b.dtype == alens.dtype == torch.int64
            and a.dim() == b.dim() == 2 and a.shape[0] == b.shape[0]
            == alens.shape[0] and a.is_contiguous() and b.is_contiguous()
            and alens.is_contiguous()):
        raise TypeError("inter_cuda: contiguous CUDA int64 [P, S1] and "
                        "[P, S2] code matrices and int64 [P] lengths "
                        "expected")
    P = a.shape[0]
    out = torch.empty(P, dtype=torch.int64, device=a.device)
    f = _fn("rt_set_intersect", [_P, _P, _L, _P, _L, _L, _P, _P])
    rc = f(a.data_ptr(), alens.data_ptr(), a.shape[1], b.data_ptr(),
           b.shape[1], P, out.data_ptr(), _ops.stream(out))
    _ops.count(inter_cuda)
    _ops.check(rc, "set_intersect_counts")
    return out


inter_cuda.launches = 0


def _pad_sets(sets: Sequence[np.ndarray], fill: np.int64
              ) -> tuple:
    P = len(sets)
    lens = np.zeros(_pow2_len(max(P, 1)), dtype=np.int64)
    lens[:P] = np.fromiter((len(s) for s in sets), np.int64, count=P)
    width = _pow2_len(max(int(lens.max()) if P else 0, 1))
    mat = np.full((lens.shape[0], width), fill, dtype=np.int64)
    for i, s in enumerate(sets):
        if len(s):
            mat[i, :len(s)] = s
    return mat, lens, lens.shape[0]


def set_intersect_counts_padded(a_mat: np.ndarray, alens: np.ndarray,
                                b_mat: np.ndarray, blens: np.ndarray
                                ) -> np.ndarray:
    """Pre-padded variant of ``set_intersect_counts`` for callers that
    gather pair rows out of one shared record matrix (FuzzyJoin verify:
    pad each record once, then every candidate pair is a fancy-index —
    no per-pair python assembly).  ``b_mat`` rows must be sorted with the
    int64 sentinel as padding; ``a_mat`` rows are masked by ``alens``.
    ``blens`` is accepted for the reference's signature: the sentinel
    padding already bounds every search."""
    P = int(a_mat.shape[0])
    if P == 0:
        return np.zeros(0, dtype=np.int64)
    pp = _pow2_len(P)
    if pp != P:             # pow2 row padding keeps the shapes stable
        a2 = np.zeros((pp, a_mat.shape[1]), dtype=np.int64)
        a2[:P] = a_mat
        b2 = np.full((pp, b_mat.shape[1]), _SENTINEL, dtype=np.int64)
        b2[:P] = b_mat
        l2 = np.zeros(pp, dtype=np.int64)
        l2[:P] = alens
        a_mat, b_mat, alens = a2, b2, l2
    a_mat = np.ascontiguousarray(a_mat, dtype=np.int64)
    b_mat = np.ascontiguousarray(b_mat, dtype=np.int64)
    alens = np.ascontiguousarray(alens, dtype=np.int64)
    ops, missed = _pool.fetch([a_mat, alens, b_mat])
    note_shape("set_intersect_counts", pp, a_mat.shape[1], b_mat.shape[1])
    if ops[0].is_cuda:
        out_t = inter_cuda(ops[0], ops[1], ops[2])
    else:
        out_t = inter_plain(ops[0], ops[1], ops[2])
    out = out_t.cpu().numpy()
    _record_dispatch("set_intersect_counts", h2d=missed, d2h=[out])
    return out[:P]


def set_intersect_counts(a_sets: Sequence[np.ndarray],
                         b_sets: Sequence[np.ndarray]) -> np.ndarray:
    """``|a_sets[i] & b_sets[i]|`` per pair.  Each set is a sorted array
    of distinct dictionary codes; the b side pads with an int64 sentinel
    (stays sorted) and the a side is masked by its true length, so pads
    never match.  Codes are exact int64 on every route."""
    P = len(a_sets)
    if P == 0:
        return np.zeros(0, dtype=np.int64)
    a_mat, alens, _ = _pad_sets(a_sets, np.int64(0))
    b_mat, blens, _ = _pad_sets(b_sets, _SENTINEL)
    return set_intersect_counts_padded(a_mat[:P], alens[:P], b_mat[:P],
                                       blens[:P])


# ---------------------------------------------------------------------------
# A7: bitset popcount intersection (FuzzyJoin verify, small vocabularies)
# ---------------------------------------------------------------------------

def popcount_plain(bits: torch.Tensor, ai: torch.Tensor,
                   bi: torch.Tensor) -> torch.Tensor:
    """A7's plain version: int64 [P].  PyTorch has no popcount, so the
    ANDed words (int32, the uint32 bits) widen to int64 and count by SWAR
    arithmetic."""
    x = (bits[ai] & bits[bi]).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum(1)


def popcount_cuda(bits: torch.Tensor, ai: torch.Tensor,
                  bi: torch.Tensor) -> torch.Tensor:
    """A7 on the card: int64 [P]."""
    if bits.dim() == 2 and bits.shape[0] >= 2 ** 31:
        raise ValueError(f"popcount_cuda: {bits.shape[0]} rows; the kernel "
                         "takes row indices as 32-bit, below 2**31 rows")
    if not (bits.is_cuda and ai.is_cuda and bi.is_cuda
            and bits.dtype == torch.int32 and bits.dim() == 2
            and bits.is_contiguous() and ai.dtype == bi.dtype == torch.int64
            and ai.is_contiguous() and bi.is_contiguous()
            and ai.shape == bi.shape):
        raise TypeError("popcount_cuda: contiguous CUDA int32 [R, W] bitsets "
                        "and int64 [P] pair indices expected")
    P = ai.shape[0]
    out = torch.empty(P, dtype=torch.int64, device=bits.device)
    f = _fn("rt_bitset_intersect", [_P, _L, _P, _P, _L, _P, _P])
    rc = f(bits.data_ptr(), bits.shape[1], ai.data_ptr(), bi.data_ptr(), P,
           out.data_ptr(), _ops.stream(out))
    _ops.count(popcount_cuda)
    _ops.check(rc, "bitset_intersect_counts")
    return out


popcount_cuda.launches = 0


def encode_bitsets(codes: np.ndarray, seg: np.ndarray, n_rows: int,
                   vocab_size: int) -> np.ndarray:
    """[n_rows, W] uint32 vocabulary bitsets from (row segment, code)
    pairs — the dense-dictionary fast path for pairwise set intersection
    when the vocabulary is small enough that a record is a few machine
    words.  Build is pure numpy: one argsort + one ``bitwise_or.reduceat``
    over the (row, word) groups, no per-token python loop."""
    W = _pow2_len(max((vocab_size + 31) // 32, 1))
    bits = np.zeros(n_rows * W, dtype=np.uint32)
    if codes.shape[0]:
        keys = seg.astype(np.int64) * W + (codes >> 5)
        vals = np.left_shift(np.uint32(1),
                             (codes & 31).astype(np.uint32))
        order = np.argsort(keys, kind="stable")
        keys, vals = keys[order], vals[order]
        # keys are sorted: group starts come from one diff, not a resort
        starts = np.flatnonzero(np.concatenate(
            [np.ones(1, dtype=bool), keys[1:] != keys[:-1]]))
        bits[keys[starts]] = np.bitwise_or.reduceat(vals, starts)
    return bits.reshape(n_rows, W)


def bitset_intersect_counts(bits: np.ndarray, ai: np.ndarray,
                            bi: np.ndarray) -> np.ndarray:
    """``popcount(bits[ai[p]] & bits[bi[p]])`` per pair (int64): the
    record matrix crosses to the device once and the pair gathers happen
    inside the kernel.  Index arrays pad to pow2 with row 0 and the
    record rows to pow2, keeping the pooled shapes stable as the candidate
    count varies; the kernel counts the live pairs only.  The uint32
    words travel as int32 (the same bits): PyTorch's uint32 support is
    partial."""
    P = int(ai.shape[0])
    if P == 0:
        return np.zeros(0, dtype=np.int64)
    R = int(bits.shape[0])
    if min(int(ai.min()), int(bi.min())) < 0 \
            or max(int(ai.max()), int(bi.max())) >= R:
        raise IndexError("bitset_intersect_counts: pair index out of range")
    pp = _pow2_len(P)
    if pp != P:
        ai = np.concatenate([ai, np.zeros(pp - P, dtype=np.int64)])
        bi = np.concatenate([bi, np.zeros(pp - P, dtype=np.int64)])
    rp = _pow2_len(max(R, 1))
    if rp != R:
        bits = np.concatenate(
            [bits, np.zeros((rp - R, bits.shape[1]), dtype=np.uint32)])
    words = np.ascontiguousarray(bits, dtype=np.uint32).view(np.int32)
    ops, missed = _pool.fetch([words,
                               np.ascontiguousarray(ai, dtype=np.int64),
                               np.ascontiguousarray(bi, dtype=np.int64)])
    note_shape("bitset_intersect_counts", rp, words.shape[1], pp)
    # the pooled index buffers keep their pow2 length; only the P live
    # pairs are counted (the padding pairs' counts were thrown away)
    ai_t, bi_t = ops[1][:P], ops[2][:P]
    if ops[0].is_cuda:
        out_t = popcount_cuda(ops[0], ai_t, bi_t)
    else:
        out_t = popcount_plain(ops[0], ai_t, bi_t)
    out = out_t.cpu().numpy()
    _record_dispatch("bitset_intersect_counts", h2d=missed, d2h=[out])
    return out


def jaccard_from_counts(inter: np.ndarray, a_sizes: np.ndarray,
                        b_sizes: np.ndarray) -> np.ndarray:
    """Finish Jaccard from intersection counts in float64 — the one
    place the division and the two-empty-sets -> 1.0 convention live, so
    every batched path matches the scalar ``similarity_jaccard`` oracle
    bit-for-bit."""
    inter = inter.astype(np.float64)
    union = a_sizes + b_sizes - inter
    return np.where(union > 0, inter / np.maximum(union, 1.0), 1.0)


def jaccard_sims(a_sets: Sequence[np.ndarray], b_sets: Sequence[np.ndarray]
                 ) -> np.ndarray:
    """Exact float64 Jaccard similarity per pair of dictionary-coded
    sets (intersection counted by K6, the division done host-side so
    decisions match the python ``len(&)/len(|)`` oracle)."""
    inter = set_intersect_counts(a_sets, b_sets)
    al = np.fromiter((len(s) for s in a_sets), np.float64,
                     count=len(a_sets))
    bl = np.fromiter((len(s) for s in b_sets), np.float64,
                     count=len(b_sets))
    return jaccard_from_counts(inter, al, bl)
