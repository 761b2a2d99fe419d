"""K8: blockwise causal GQA flash-attention forward (the reference's
``kernels/flash_attention.py``), and its backward.

  flash_plain(q, k, v, ...)   the plain PyTorch version: the oracle
                              ``ref.flash_attention_ref`` over the valid keys
  flash_cuda(q, k, v, ...)    the CUDA kernel csrc/flash_attention.cu; with
                              ``with_lse`` also the row logsumexp
                              [B, H, Sq] the backward reads
  flash_attention_fwd(...)    dispatch on q's device
  flash_bwd_plain(q, k, v, g, ...)
                              the backward's plain version: autograd of the
                              oracle (the reference's custom VJP)
  flash_bwd_cuda(q, k, v, o, lse, g, ...)
                              the CUDA kernels csrc/flash_attention_bwd.cu

Layout: the model's, q [B, Sq, H, hd] and k/v [B, Skv, KV, hd] (H = KV*G,
query head h reads KV head h // G), output like q.  The Pallas kernel's
fused layout q [B*H, Sq, hd], k/v [B*KV, Skv, hd] is the same call with
B = 1 and the heads fused (``fused_layout``): query head b*H + h reads KV
head (b*H + h) // G = b*KV + h // G.  The kernel reads any strides with a
unit stride along hd, so the model path hands it q, k and v as they come
out of the projections, with no transpose and no padding.

Masks: ``causal`` with ``q_offset`` (query i sits at position q_offset + i)
and ``kv_len``, the number of valid keys (the rest of k and v is never
read).  The kernel loads K and V by TMA and Q as 16-byte vectors, so q, k
and v must start on 16 bytes and step by whole 16-byte units along every
axis of extent above 1; a view that does not raises ``TypeError``.  The
reference's ``ops.flash_attention`` lets zero-padded keys into the softmax
when causal, Sq > Skv and Skv is not a block multiple; this port follows
the oracle instead (tests/test_torch_model_ops.py).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from . import ops as _ops
from .ref import flash_attention_ref
from .rmsnorm import DTYPES

__all__ = ["flash_plain", "flash_cuda", "flash_attention_fwd",
           "flash_bwd_plain", "flash_bwd_cuda", "fused_layout", "HEAD_DIMS",
           "launch_plan"]

HEAD_DIMS = (16, 32, 64, 128)
_WARPS = 8                     # csrc/flash_attention.cu NWC: 16 rows each


def launch_plan(B: int, H: int, KV: int, Sq: int) -> tuple:
    """(GH, BQ, grid) of K8's launch, a function of the shape alone: a CTA
    takes GH of a KV head's G = H / KV query heads (the largest of 8, 4, 2,
    1 dividing G) over BQ = 16 * 8 / GH queries, so its 8 warps hold 16
    query rows each and every K/V tile it loads serves 128 rows."""
    G = H // KV
    GH = next(c for c in (8, 4, 2, 1) if G % c == 0)
    BQ = 16 * (_WARPS // GH)
    return GH, BQ, -(-Sq // BQ) * B * KV * (G // GH)


def _aligned(t: torch.Tensor) -> bool:
    """16-byte base and whole 16-byte steps along every axis of extent
    above 1 (unit stride along the last)."""
    esz = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(t.stride(i) * esz % 16 == 0
                    for i in range(t.dim() - 1) if t.shape[i] > 1))


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = True, q_offset: int = 0,
                kv_len: Optional[int] = None) -> torch.Tensor:
    """K8's plain version: the oracle over keys [0, kv_len)."""
    n = k.shape[1] if kv_len is None else kv_len
    return flash_attention_ref(q, k[:, :n], v[:, :n], causal=causal,
                               q_offset=q_offset)


def _strides(t: torch.Tensor) -> "ctypes.Array":
    return (ctypes.c_int64 * 3)(t.stride(0), t.stride(1), t.stride(2))


def flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True, q_offset: int = 0,
               kv_len: Optional[int] = None, with_lse: bool = False
               ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K8 on the card: [B, Sq, H, hd] in q's dtype; with ``with_lse`` the
    pair (out, lse), lse [B, H, Sq] float32 the logsumexp of each row's
    scaled scores."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    n = k.shape[1] if kv_len is None else kv_len
    if not (q.is_cuda and k.is_cuda and v.is_cuda and q.dim() == 4
            and k.dim() == 4 and k.shape == v.shape
            and k.stride() == v.stride() and k.shape[0] == B
            and k.shape[3] == hd and H % KV == 0
            and q.dtype == k.dtype == v.dtype and q.dtype in DTYPES
            and hd in HEAD_DIMS and 1 <= n <= k.shape[1]
            and _aligned(q) and _aligned(k) and _aligned(v)):
        raise TypeError("flash_cuda: CUDA float32/bfloat16 q [B, Sq, H, hd] "
                        "and k, v [B, Skv, KV, hd] (same strides, unit "
                        "stride along hd, 16-byte aligned with 16-byte "
                        f"steps, hd in {HEAD_DIMS}, 1 <= kv_len <= Skv) "
                        "expected")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    f = _ops.lib().rt_flash_attention
    f.restype = ctypes.c_int
    I, P = ctypes.c_int, ctypes.c_void_p
    f.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P, P, P, I, I,
                  ctypes.c_float, I, P, P]
    qs, ks, os_ = _strides(q), _strides(k), _strides(out)
    gh = launch_plan(B, H, KV, Sq)[0]
    rc = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           DTYPES[q.dtype], B, H, KV, Sq, n, hd, ctypes.addressof(qs),
           ctypes.addressof(ks), ctypes.addressof(os_), int(bool(causal)),
           q_offset, 1.0 / math.sqrt(hd), gh,
           None if lse is None else lse.data_ptr(), _ops.stream(q))
    _ops.count(flash_cuda)
    _ops.check(rc, "flash_attention")
    return (out, lse) if with_lse else out


flash_cuda.launches = 0


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """K8 for CUDA tensors (raises on what it does not take), its plain
    version for CPU ones."""
    if q.is_cuda:
        return flash_cuda(q, k, v, causal, q_offset, kv_len)
    return flash_plain(q, k, v, causal, q_offset, kv_len)


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, causal: bool = True, q_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8 backward's plain version: (dq, dk, dv) of the output gradient g,
    by autograd of the oracle (what the reference's custom VJP,
    ``ops._flash_vjp_bwd``, computes)."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*qkv, causal=causal, q_offset=q_offset)
        return tuple(torch.autograd.grad(out, qkv, g))


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                   causal: bool = True, q_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8 backward on the card: (dq, dk, dv) in q's dtype, given the
    forward's output ``o`` and row logsumexp ``lse`` (``flash_cuda(...,
    with_lse=True)``) and the output gradient ``g``.  Operands that are not
    contiguous, or not 16-byte aligned, are copied first."""
    B, Sq, H, hd = q.shape
    KV, Skv = k.shape[2], k.shape[1]
    if not (q.is_cuda and k.is_cuda and v.is_cuda and o.is_cuda
            and g.is_cuda and lse.is_cuda and q.dim() == 4
            and k.shape == v.shape and k.dim() == 4 and k.shape[0] == B
            and k.shape[3] == hd and H % KV == 0 and Skv >= 1
            and o.shape == q.shape and g.shape == q.shape
            and q.dtype == k.dtype == v.dtype == o.dtype == g.dtype
            and q.dtype in DTYPES and hd in HEAD_DIMS
            and lse.dtype == torch.float32
            and tuple(lse.shape) == (B, H, Sq)):
        raise TypeError("flash_bwd_cuda: CUDA float32/bfloat16 q, o, g "
                        "[B, Sq, H, hd], k, v [B, Skv, KV, hd] (one dtype, "
                        f"hd in {HEAD_DIMS}) and float32 lse [B, H, Sq] "
                        "expected")
    # contiguous, and 16-byte aligned for the float32 kernels' TMA tiles and
    # vector loads (a contiguous view at an odd offset is copied)
    q, k, v, o, g, lse = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                          else t.clone(memory_format=torch.contiguous_format)
                          for t in (q, k, v, o, g, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    f = _ops.lib().rt_flash_attention_bwd
    f.restype = ctypes.c_int
    I, P = ctypes.c_int, ctypes.c_void_p
    f.argtypes = [P] * 10 + [I] * 9 + [ctypes.c_float, P]
    rc = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           g.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype], B, H, KV, Sq, Skv,
           hd, int(bool(causal)), q_offset, 1.0 / math.sqrt(hd),
           _ops.stream(q))
    _ops.count(flash_bwd_cuda)
    _ops.check(rc, "flash_attention_bwd")
    return dq, dk, dv


flash_bwd_cuda.launches = 0


def fused_layout(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> tuple:
    """View the Pallas kernel's q [B*H, Sq, hd], k/v [B*KV, Skv, hd] as the
    model layout with B = 1 (no copy)."""
    return (q.permute(1, 0, 2).unsqueeze(0), k.permute(1, 0, 2).unsqueeze(0),
            v.permute(1, 0, 2).unsqueeze(0))
