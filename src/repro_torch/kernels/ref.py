"""Plain PyTorch versions of the model-stack kernels (the reference's
``kernels/ref.py``, the oracles its Pallas kernels are held against).

These are the functions K7-K9 compute, written as the reference writes
them: the CPU route of every wrapper and the yardstick each CUDA kernel is
checked against on the card.  Layouts are the reference's: q
[B, Sq, H, hd], k/v [B, Skv, KV, hd] with H = KV * G (query head h reads
KV head h // G).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

__all__ = ["NEG_INF", "flash_attention_ref", "decode_partial_ref",
           "merge_partials_ref", "rmsnorm_ref"]

NEG_INF = -1e30

Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """Plain softmax attention, f32 inside, output in q's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, hd) / math.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float())
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        mask = torch.arange(k.shape[1], device=q.device)[None, :] \
            <= q_pos[:, None]
        s = torch.where(mask[None, None, None], s,
                        torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def decode_partial_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid_len: Union[int, torch.Tensor]) -> Partial:
    """Un-normalized attention of one token over ONE KV component.

    q: [B, H, hd]; k/v: [B, S_c, KV, hd]; rows >= ``valid_len`` masked.
    Returns the flash state (acc [B, H, hd], m [B, H], l [B, H]), f32."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, hd) / math.sqrt(hd)
    s = torch.einsum("bkgh,bskh->bkgs", qf, k.float())
    valid = torch.arange(k.shape[1], device=q.device) < valid_len
    s = torch.where(valid[None, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid[None, None, None, :], p,
                    torch.zeros((), device=q.device))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return acc.reshape(B, H, hd), m.reshape(B, H), l.reshape(B, H)


def merge_partials_ref(partials: Sequence[Partial]) -> torch.Tensor:
    """Normalize the logsumexp merge of per-component partials (the LSM
    component merge: associative, so any grouping gives the same)."""
    acc, m, l = partials[0]
    for a2, m2, l2 in partials[1:]:
        m_new = torch.maximum(m, m2)
        w1 = torch.exp(m - m_new)
        w2 = torch.exp(m2 - m_new)
        acc = acc * w1[..., None] + a2 * w2[..., None]
        l = l * w1 + l2 * w2
        m = m_new
    return acc / torch.clamp(l, min=1e-20)[..., None]


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
