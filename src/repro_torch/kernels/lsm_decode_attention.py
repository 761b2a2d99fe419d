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
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import ops as _ops
from .flash_attention import HEAD_DIMS
from .ref import Partial, decode_partial_ref
from .rmsnorm import DTYPES

__all__ = ["decode_partial_plain", "decode_partial_cuda", "decode_partial",
           "MAX_GROUP_WIDTH"]

# G * hd accumulators per CTA: 16 registers of 256 threads
MAX_GROUP_WIDTH = 16 * 256

decode_partial_plain = decode_partial_ref      # K9's plain version


def decode_partial_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid_len: int) -> Partial:
    """K9 on the card."""
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
    f.argtypes = [P, P, P, I, P, P, P, I, I, I, I, ctypes.c_int64, I,
                  ctypes.c_float, P]
    rc = f(qf.data_ptr(), k.data_ptr(), v.data_ptr(), DTYPES[k.dtype],
           acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, KV, hd, Sc, n,
           1.0 / math.sqrt(hd), _ops.stream(q))
    decode_partial_cuda.launches += 1
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
