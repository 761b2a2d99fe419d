"""The model stack's kernel wrappers: the counterpart of the reference's
``kernels/ops.py:52-134`` (this module is not called ``ops`` because the
port's ``kernels/ops.py`` holds the device and build plumbing).

  flash_attention(q, k, v, causal, q_offset)   K8 forward; its backward
                                               is K8's backward kernels on
                                               the card (the forward saves
                                               its output and row
                                               logsumexp for them) and, on
                                               the CPU, autograd of the
                                               plain oracle, as the
                                               reference's custom VJP does
  lsm_decode_attention(q, components)          K9 per component, then the
                                               logsumexp merge
  rmsnorm(x, w, eps)                           K7 over any leading axes;
                                               its backward is K7's
                                               backward kernel on the card
                                               and its plain version on
                                               the CPU

Each runs its kernel for CUDA tensors and the kernel's plain version for
CPU ones, forward and backward: no plain version runs on the card.  The
reference pads to block multiples here; the port's kernels mask their
ragged edges themselves, so nothing is padded.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .flash_attention import flash_bwd_cuda, flash_bwd_plain, flash_cuda, \
    flash_plain
from .lsm_decode_attention import decode_partial
from .ref import merge_partials_ref
from .rmsnorm import rmsnorm as _rmsnorm
from .rmsnorm import rmsnorm_bwd

__all__ = ["flash_attention", "lsm_decode_attention", "rmsnorm"]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        ctx.causal, ctx.q_offset = causal, q_offset
        if not q.is_cuda:
            ctx.save_for_backward(q, k, v)
            return flash_plain(q, k, v, causal, q_offset)
        if not any(ctx.needs_input_grad[:3]):   # no gradient: no lse
            return flash_cuda(q, k, v, causal, q_offset)
        out, lse = flash_cuda(q, k, v, causal, q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors              # unpacked once (remat)
        if len(saved) == 3:                    # the CPU: the oracle's VJP
            grads = flash_bwd_plain(*saved, g, ctx.causal, ctx.q_offset)
        else:
            grads = flash_bwd_cuda(*saved, g, ctx.causal, ctx.q_offset)
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


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, eps):
        ctx.save_for_backward(x2, w)
        ctx.eps = eps
        return _rmsnorm(x2, w, eps)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x2, w, g.contiguous(), ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: [..., d]; w: [d]."""
    shape = x.shape
    return _RMSNorm.apply(x.reshape(-1, shape[-1]).contiguous(), w,
                          eps).reshape(shape)
