"""K7: row RMSNorm with float32 accumulation (the reference's
``kernels/rmsnorm.py``).

  rmsnorm_plain(x, w, eps)   the plain PyTorch version (ref.rmsnorm_ref)
  rmsnorm_cuda(x, w, eps)    the CUDA kernel csrc/rmsnorm.cu
  rmsnorm(x, w, eps)         dispatch on x's device

x is [N, d] (float32 or bfloat16), w is [d] (either); the output has x's
dtype.  The kernel takes any N (it walks the rows itself), so nothing is
padded; ``model_ops.rmsnorm`` flattens the leading axes.
"""

from __future__ import annotations

import ctypes

import torch

from . import ops as _ops
from .ref import rmsnorm_ref

__all__ = ["rmsnorm_plain", "rmsnorm_cuda", "rmsnorm", "DTYPES"]

# mirror of MT_F32 / MT_BF16 in csrc/model_common.cuh
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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
                  ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]
    rc = f(x.data_ptr(), DTYPES[x.dtype], w.data_ptr(), DTYPES[w.dtype],
           out.data_ptr(), N, d, eps, _ops.stream(x))
    rmsnorm_cuda.launches += 1
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
