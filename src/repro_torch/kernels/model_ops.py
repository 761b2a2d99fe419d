"""The model stack's kernel wrappers: the counterpart of the reference's
``kernels/ops.py:52-134`` (this module is not called ``ops`` because the
port's ``kernels/ops.py`` holds the device and build plumbing).

  flash_attention(q, k, v, causal, q_offset)   K8 forward; the backward
                                               recomputes through the
                                               plain oracle, as the
                                               reference's custom VJP does
  lsm_decode_attention(q, components)          K9 per component, then the
                                               logsumexp merge
  rmsnorm(x, w, eps)                           K7 over any leading axes

Each runs its kernel for CUDA tensors and the kernel's plain version for
CPU ones.  The reference pads to block multiples here; the port's kernels
mask their ragged edges themselves, so nothing is padded.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .flash_attention import flash_attention_fwd
from .lsm_decode_attention import decode_partial
from .ref import flash_attention_ref, merge_partials_ref
from .rmsnorm import rmsnorm as _rmsnorm

__all__ = ["flash_attention", "lsm_decode_attention", "rmsnorm"]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_offset = causal, q_offset
        return flash_attention_fwd(q, k, v, causal, q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flash_attention_ref(*qkv, causal=ctx.causal,
                                      q_offset=ctx.q_offset)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd] -> [B, Sq, H, hd]."""
    return _FlashAttention.apply(q, k, v, causal, q_offset)


def lsm_decode_attention(
        q: torch.Tensor,
        components: Sequence[Tuple[torch.Tensor, torch.Tensor, int]]
) -> torch.Tensor:
    """Decode attention over tiered KV components (k, v, valid_len), each
    k/v [B, S_c, KV, hd]: one K9 launch per component, the un-normalized
    states merged associatively and normalized once.  -> [B, H, hd] in
    q's dtype."""
    partials = [decode_partial(q, k, v, vl) for k, v, vl in components]
    return merge_partials_ref(partials).to(q.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: [..., d]; w: [d]."""
    shape = x.shape
    return _rmsnorm(x.reshape(-1, shape[-1]).contiguous(), w,
                    eps).reshape(shape)
