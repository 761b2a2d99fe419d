"""Similarity kernels for the fuzzy query subsystem: the part on the
port's main path.

  fnv1a_hash(tokens)             vectorized FNV-1a-64 over a padded byte
                                 matrix (pure numpy, copied as is)
  t_occurrence_mask(pos, n, T)   K4: posting-position hits -> bool bitmap
                                 of rows with >= T hits; at T = 1 this is
                                 every secondary-index candidate bitmap

``positions`` is either one host array of row positions (the reference's
signature) or a list of :class:`Segment` s — slices of immutable posting
arrays plus a row offset.  Segment arrays go through the device pool, so
an index probe over resident postings ships nothing host -> device.

The reference module's batched edit distance (K5), set intersection (K6)
and bitset cores belong to the fuzzy slice of the port; until it lands
they raise through :func:`fuzzy_pending`.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from . import device_pool as _pool
from . import ops as _ops
from .columnar_ops import note_shape
from ..obs import record_dispatch as _record_dispatch
from ..columnar.batch import pow2_len as _pow2_len

__all__ = ["fnv1a_hash", "t_occurrence_mask", "Segment", "tocc_plain",
           "tocc_cuda", "fuzzy_pending", "edit_distances"]

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def fuzzy_pending(what: str) -> None:
    """Refuse a fuzzy-subsystem feature the port does not have yet."""
    raise NotImplementedError(
        f"{what}: the fuzzy slice (edit-distance and set-intersection "
        f"kernels K5/K6, ngram postings) is not ported to repro_torch yet")


def edit_distances(strs: Sequence[str], query: str, d: int) -> np.ndarray:
    fuzzy_pending("edit_distances")
    raise AssertionError("unreachable")


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
    """``positions[start:stop] + offset``: one tier's posting slice."""
    positions: np.ndarray
    start: int
    stop: int
    offset: int


# device segment: (int64 tensor, start, count, offset)
DevSeg = Tuple[torch.Tensor, int, int, int]


def tocc_plain(segs: Sequence[DevSeg], n: int, n_out: int,
               threshold: int) -> torch.Tensor:
    """K4's plain version: bool [n_out], rows < n with >= T hits."""
    dev = segs[0][0].device
    pos = torch.cat([t[a:a + c] + off for t, a, c, off in segs])
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


def tocc_cuda(segs: Sequence[DevSeg], n: int, n_out: int,
              threshold: int) -> torch.Tensor:
    """K4 on the card: bool [n_out]."""
    dev = segs[0][0].device
    descs = (SegDesc * len(segs))()
    for j, (t, a, c, off) in enumerate(segs):
        if not (t.is_cuda and t.dtype == torch.int64 and t.is_contiguous()):
            raise TypeError("t_occurrence_mask: contiguous CUDA int64 "
                            "positions expected")
        descs[j].pos, descs[j].start = t.data_ptr(), a
        descs[j].count, descs[j].offset = c, off
    out = torch.empty(n_out, dtype=torch.bool, device=dev)
    counts = torch.empty(n + 1 if threshold > 1 else 1, dtype=torch.int32,
                         device=dev)
    f = _ops.lib().rt_t_occurrence
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                  ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p]
    rc = f(ctypes.cast(descs, ctypes.c_void_p), len(segs), n, n_out,
           threshold, counts.data_ptr(), out.data_ptr(), _ops.stream(out))
    tocc_cuda.launches += 1
    _ops.check(rc, "t_occurrence_mask")
    return out


tocc_cuda.launches = 0


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
    dsegs = [(t, int(s.start), int(s.stop - s.start), int(s.offset))
             for t, s in zip(ops, segs)]
    np2 = _pow2_len(n)
    note_shape("t_occurrence_mask", np2, _pow2_len(m), threshold == 1)
    if ops[0].is_cuda:
        out_t = tocc_cuda(dsegs, n, np2, threshold)
    else:
        out_t = tocc_plain(dsegs, n, np2, threshold)
    out = out_t.cpu().numpy()
    _record_dispatch("t_occurrence_mask", h2d=missed, d2h=[out])
    return out[:n]
