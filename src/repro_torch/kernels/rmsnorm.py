"""K7: row RMSNorm with float32 accumulation (the reference's
``kernels/rmsnorm.py``).

  rmsnorm_plain(x, w, eps)   the plain PyTorch version (ref.rmsnorm_ref)
  rmsnorm_cuda(x, w, eps)    the CUDA kernel csrc/rmsnorm.cu
  rmsnorm(x, w, eps)         dispatch on x's device

x is [N, d] (float32 or bfloat16), w is [d] (either); the output has x's
dtype.  The kernel takes any N (it walks the rows itself), so nothing is
padded; ``model_ops.rmsnorm`` flattens the leading axes.  For a few rows
(a decode step) it splits each row over a cluster of ``cluster_size``
CTAs.
"""

from __future__ import annotations

import ctypes

import torch

from . import ops as _ops
from .ref import rmsnorm_ref

__all__ = ["rmsnorm_plain", "rmsnorm_cuda", "rmsnorm", "DTYPES",
           "CLUSTER_MAX_ROWS", "cluster_size"]

# mirror of MT_F32 / MT_BF16 in csrc/model_common.cuh
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# up to this many rows each row gets a cluster (132 SMs / 2); past it one
# block a row.  A rank holds at most 256 threads x 8 vectors of its slice.
CLUSTER_MAX_ROWS = 66
_SLICE_VECTORS = 256 * 8


def cluster_size(N: int, d: int, dtype: torch.dtype,
                 aligned: bool = True) -> int:
    """CTAs per row of K7's launch: 8, 4 or 2 (the largest that splits
    the row's 16-byte vectors evenly) when ``N <= CLUSTER_MAX_ROWS`` and
    the rows are 16-byte aligned, else 1 (one block a row)."""
    vw = 16 // (torch.finfo(dtype).bits // 8)
    if N > CLUSTER_MAX_ROWS or d % vw or not aligned:
        return 1
    nv = d // vw
    for c in (8, 4, 2):
        if nv % c == 0 and nv // c <= _SLICE_VECTORS:
            return c
    return 1


rmsnorm_plain = rmsnorm_ref            # K7's plain version


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """K7 on the card: [N, d] in x's dtype."""
    if not (x.is_cuda and w.is_cuda and x.dim() == 2 and w.dim() == 1
            and x.shape[1] == w.shape[0] and x.is_contiguous()
            and w.is_contiguous() and x.dtype in DTYPES
            and w.dtype in DTYPES):
        raise TypeError("rmsnorm_cuda: contiguous CUDA float32/bfloat16 "
                        "x [N, d] and w [d] expected")
    N, d = x.shape
    out = torch.empty_like(x)
    f = _ops.lib().rt_rmsnorm
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                  ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                  ctypes.c_void_p]
    C = cluster_size(N, d, x.dtype, x.data_ptr() % 16 == 0)
    rc = f(x.data_ptr(), DTYPES[x.dtype], w.data_ptr(), DTYPES[w.dtype],
           out.data_ptr(), N, d, eps, C, _ops.stream(x))
    _ops.count(rmsnorm_cuda)
    _ops.check(rc, "rmsnorm")
    return out


rmsnorm_cuda.launches = 0


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """K7 for a CUDA ``x`` (raises on what it does not take), its plain
    version for a CPU one."""
    if x.is_cuda:
        return rmsnorm_cuda(x, w, eps)
    return rmsnorm_plain(x, w, eps)
