"""K9: decode attention of one token over ONE KV component, masked by
``valid_len``, returning the un-normalized flash state (the reference's
``kernels/lsm_decode_attention.py``, the paper's C3 on the card).

  decode_partial_plain(q, k, v, valid_len)   ref.decode_partial_ref
  decode_partial_cuda(q, k, v, valid_len)    csrc/lsm_decode_attention.cu
  decode_partial(q, k, v, valid_len)         dispatch on q's device

q [B, H, hd] (any float dtype; read as float32, as the reference reads
it); k/v [B, S_c, KV, hd] (contiguous, 16-byte aligned; float32 or
bfloat16; hd 16, 32, 64 or 128); ``valid_len`` a host int.  Returns (acc [B, H, hd], m [B, H], l [B, H]),
all float32; components merge by ``ref.merge_partials_ref``.  The kernel
reads only the valid rows, so a component's padding is never streamed.

On the card one cluster of C CTAs takes each (batch, KV head): the CTAs
split the valid rows by ``split_plan`` (C from ``cluster_size``) and the
cluster merges their states in rank order inside the launch.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Callable, List, Tuple

import torch

from . import ops as _ops
from .flash_attention import HEAD_DIMS
from .ref import Partial, decode_partial_ref
from .rmsnorm import DTYPES

__all__ = ["decode_partial_plain", "decode_partial_cuda", "decode_partial",
           "MAX_GROUP_WIDTH", "MAX_CLUSTER", "split_plan", "split_ranges",
           "cluster_size", "launch_plan"]

# G * hd the kernel takes: its p.V partial sums fill at most 32 KB
MAX_GROUP_WIDTH = 16 * 256
# CTAs a cluster (the portable maximum); the kernel's tile (its BK): a
# rank gets at least one, and ranges start on tile boundaries
MAX_CLUSTER = 8
TILE_ROWS = 64


def split_plan(valid_len: int, clusters: int = 0) -> Tuple[int, int]:
    """(C, chunk): how K9 splits the valid rows [0, valid_len) of one
    (batch, KV head) over a cluster of C CTAs.  Rank r takes rows
    [r * chunk, min(valid_len, (r + 1) * chunk)), empty when r * chunk >=
    valid_len.  C is ``clusters`` when given, else valid_len // 64
    clamped to [1, 8], so no rank is left without a whole tile; chunk is
    ceil(valid_len / C) rounded up to a whole tile."""
    n = max(0, int(valid_len))
    C = clusters or max(1, min(MAX_CLUSTER, n // TILE_ROWS))
    chunk = -(-n // C)
    return C, -(-chunk // TILE_ROWS) * TILE_ROWS


def split_ranges(valid_len: int, clusters: int = 0) -> List[Tuple[int, int]]:
    """The C row ranges [lo, hi) of ``split_plan``, in rank order."""
    n = max(0, int(valid_len))
    C, chunk = split_plan(n, clusters)
    return [(min(n, r * chunk), min(n, (r + 1) * chunk)) for r in range(C)]


def cluster_size(valid_len: int, pairs: int,
                 resident: Callable[[int], int]) -> int:
    """The C K9 launches with for ``pairs`` (batch, KV head) clusters:
    the largest C up to ``split_plan``'s that lets all of them be
    resident at once (``resident(C)`` clusters fit on the card), and no
    larger than the ranks its rows fill, so no rank is empty; 1 when none
    fits (then one CTA per pair already fills the card)."""
    n = max(0, int(valid_len))
    for c in range(split_plan(n)[0], 1, -1):
        if pairs <= resident(c):
            return -(-n // split_plan(n, c)[1])
    return 1


@lru_cache(maxsize=None)
def _resident(dt: int, hd: int, G: int, C: int) -> int:
    """Clusters of C CTAs of K9's kernel the card holds at once."""
    f = _ops.lib().rt_decode_partial_clusters
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    out = ctypes.c_int(0)
    _ops.check(f(dt, hd, G, C, ctypes.byref(out)), "lsm_decode_attention")
    return out.value


@lru_cache(maxsize=4096)
def launch_plan(valid_len: int, pairs: int, dt: int, hd: int,
                G: int) -> Tuple[int, int]:
    """(C, chunk) of the CUDA launch over ``pairs`` = B * KV clusters of
    element type code ``dt``, head dim ``hd`` and group ``G`` (cached:
    a decode step repeats the same few)."""
    return split_plan(valid_len, cluster_size(
        valid_len, pairs, lambda c: _resident(dt, hd, G, c)))


decode_partial_plain = decode_partial_ref      # K9's plain version


def decode_partial_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid_len: int) -> Partial:
    """K9 on the card: one launch of B * KV clusters of C CTAs."""
    B, H, hd = q.shape
    _, Sc, KV, _ = k.shape
    if not (q.is_cuda and k.is_cuda and v.is_cuda and k.shape == v.shape
            and k.shape[0] == B and k.shape[3] == hd and H % KV == 0
            and (H // KV) * hd <= MAX_GROUP_WIDTH and hd in HEAD_DIMS
            and k.dtype == v.dtype and k.dtype in DTYPES
            and q.is_floating_point() and k.is_contiguous()
            and v.is_contiguous() and k.data_ptr() % 16 == 0
            and v.data_ptr() % 16 == 0):
        raise TypeError("decode_partial_cuda: CUDA q [B, H, hd] and "
                        "contiguous, 16-byte aligned float32/bfloat16 k, v "
                        f"[B, S_c, KV, hd] with hd in {HEAD_DIMS} and "
                        f"(H / KV) * hd <= {MAX_GROUP_WIDTH} expected")
    n = max(0, min(int(valid_len), Sc))
    qf = q.float().contiguous()
    acc = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    f = _ops.lib().rt_decode_partial
    f.restype = ctypes.c_int
    I, P = ctypes.c_int, ctypes.c_void_p
    f.argtypes = [P, P, P, I, P, P, P, I, I, I, I, ctypes.c_int64, I, I, I,
                  ctypes.c_float, P]
    dt = DTYPES[k.dtype]
    C, chunk = launch_plan(n, B * KV, dt, hd, H // KV)
    rc = f(qf.data_ptr(), k.data_ptr(), v.data_ptr(), dt,
           acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, KV, hd, Sc, n,
           C, chunk, 1.0 / math.sqrt(hd), _ops.stream(q))
    _ops.count(decode_partial_cuda)
    _ops.check(rc, "lsm_decode_attention")
    return acc, m, l


decode_partial_cuda.launches = 0


def decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid_len: int) -> Partial:
    """K9 for CUDA tensors (raises on what it does not take), its plain
    version for CPU ones."""
    if q.is_cuda:
        return decode_partial_cuda(q, k, v, valid_len)
    return decode_partial_plain(q, k, v, valid_len)
