"""K7: row RMSNorm with float32 accumulation (the reference's
``kernels/rmsnorm.py``), and its backward.

  rmsnorm_plain(x, w, eps)          the plain PyTorch version
                                    (ref.rmsnorm_ref)
  rmsnorm_cuda(x, w, eps)           the CUDA kernel csrc/rmsnorm.cu
  rmsnorm(x, w, eps)                dispatch on x's device
  rmsnorm_bwd_plain(x, w, g, eps)   (dx, dw) of the output gradient g, in
                                    PyTorch: the formula XLA's autodiff of
                                    the reference's plain rmsnorm computes
  rmsnorm_bwd_cuda(x, w, g, eps)    the CUDA kernel (rt_rmsnorm_bwd in
                                    csrc/rmsnorm.cu)
  rmsnorm_bwd(x, w, g, eps)         dispatch on x's device

x is [N, d] (float32 or bfloat16), w is [d] (either); the output has x's
dtype.  The kernel takes any N (it walks the rows itself), so nothing is
padded; ``model_ops.rmsnorm`` flattens the leading axes.  For a few rows
(a decode step) it splits each row over a cluster of ``cluster_size``
CTAs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import ops as _ops
from .ref import rmsnorm_ref

__all__ = ["rmsnorm_plain", "rmsnorm_cuda", "rmsnorm", "rmsnorm_bwd_plain",
           "rmsnorm_bwd_cuda", "rmsnorm_bwd", "DTYPES", "CLUSTER_MAX_ROWS",
           "cluster_size"]

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


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def rmsnorm_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 backward's plain version: with rstd = rsqrt(mean(x^2) + eps) and
    xh = x rstd, dx = rstd (w g - xh mean(w g xh)) and dw = the sum over
    rows of g xh, in float32; dx in x's dtype, dw in w's."""
    xf, gf, wf = x.float(), g.float(), w.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xh = xf * r
    wg = wf * gf
    c = (wg * xh).mean(dim=-1, keepdim=True)
    dx = r * (wg - xh * c)
    dw = (gf * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 backward on the card: (dx [N, d] in x's dtype, dw [d] in w's)."""
    if not (x.is_cuda and w.is_cuda and g.is_cuda and x.dim() == 2
            and w.dim() == 1 and x.shape[1] == w.shape[0]
            and g.shape == x.shape and g.dtype == x.dtype
            and x.is_contiguous() and g.is_contiguous()
            and w.is_contiguous() and x.dtype in DTYPES
            and w.dtype in DTYPES and 1 <= x.shape[1] <= 48 * 1024):
        raise TypeError("rmsnorm_bwd_cuda: contiguous CUDA float32/bfloat16 "
                        "x, g [N, d] (one dtype) and w [d], d <= 49152, "
                        "expected")
    N, d = x.shape
    lib = _ops.lib()
    nb = lib.rt_rmsnorm_bwd_blocks
    nb.restype = ctypes.c_int
    nb.argtypes = [ctypes.c_int64]
    part = torch.empty((nb(N), d), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    f = lib.rt_rmsnorm_bwd
    f.restype = ctypes.c_int
    P = ctypes.c_void_p
    f.argtypes = [P, ctypes.c_int, P, ctypes.c_int, P, P, P, P,
                  ctypes.c_int64, ctypes.c_int64, ctypes.c_float, P]
    rc = f(x.data_ptr(), DTYPES[x.dtype], w.data_ptr(), DTYPES[w.dtype],
           g.data_ptr(), dx.data_ptr(), dw.data_ptr(), part.data_ptr(), N,
           d, eps, _ops.stream(x))
    _ops.count(rmsnorm_bwd_cuda)
    _ops.check(rc, "rmsnorm_bwd")
    return dx, dw


rmsnorm_bwd_cuda.launches = 0


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 backward for a CUDA ``x`` (raises on what it does not take), its
    plain version for a CPU one."""
    if x.is_cuda:
        return rmsnorm_bwd_cuda(x, w, g, eps)
    return rmsnorm_bwd_plain(x, w, g, eps)
