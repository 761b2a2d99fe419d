"""Collectives (the reference's ``runtime/collectives.py``): for now only
the blockwise int8 codec that error-feedback gradient compression
(``optim/grad_compress``) runs on one card.

The reference's mesh collectives (the Hyracks connector twins
``replicate``, ``partition_by``, ``partition_merge``,
``hierarchical_psum``, ``compressed_psum`` and the distributed
``logsumexp_merge``) act across the devices of a mesh and come with the
port's sharding slice (``runtime/{mesh,sharding}``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["int8_encode", "int8_decode"]


def int8_encode(x: torch.Tensor, *, block: int = 256
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization of x (flattened, zero-padded
    to whole blocks).  Returns (q [blocks, block] int8, scales [blocks, 1]
    float32); values round half to even, as ``jnp.round`` does."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def int8_decode(q: torch.Tensor, scale: torch.Tensor,
                shape: Tuple[int, ...],
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)
