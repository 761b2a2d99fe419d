"""Error-feedback int8 gradient compression (the reference's
``optim/grad_compress.py``).

Each gradient leaf plus its carried residual is quantized blockwise to
int8 and back (``runtime/collectives.int8_encode``/``int8_decode``); the
quantization error is kept and added to the next step's gradient (EF-SGD,
Karimireddy et al., 2019).  On one card this models the numerics of the
compressed cross-pod reduction; the wire saving belongs to the mesh
collectives of the sharding slice.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..runtime.collectives import int8_decode, int8_encode
from .adamw import tree_map

__all__ = ["ef_state", "ef_quantize"]


def ef_state(params: Any) -> Any:
    """Residual buffers shaped like the gradients (float32 zeros)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _leaf(g: torch.Tensor, e: torch.Tensor, block: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.to(torch.float32) + e
    q, scale = int8_encode(gf, block=block)
    deq = int8_decode(q, scale, tuple(gf.shape))
    return deq.to(g.dtype), gf - deq


def ef_quantize(grads: Any, err: Any, *, block: int = 256
                ) -> Tuple[Any, Any]:
    """Quantize-dequantize each gradient leaf with error feedback.
    Returns (compressed gradients, new residuals)."""
    pairs = tree_map(lambda g, e: _leaf(g, e, block), grads, err)
    return _split(pairs, 0), _split(pairs, 1)


def _split(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_split(v, i) for v in tree]
    return tree[i]
