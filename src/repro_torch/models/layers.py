"""Parameter specs and the basic layers (the reference's
``models/layers.py``).

Parameters are plain trees (dicts and lists of tensors).  Every leaf is
declared by a ``ParamSpec`` carrying its shape, init and logical axes; the
reference's ``abstract_params``, ``param_shardings`` and ``compute_view``
(sharding views, identities on one card) come with the port's
``runtime/sharding`` in a later slice.

``rms_norm`` is K7 on the card (``kernels/model_ops.rmsnorm``), its
gradient K7's backward kernel; the other layers are plain PyTorch (and
autograd), as the reference computes them outside any kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

from ..kernels import model_ops

__all__ = ["ParamSpec", "init_params", "count_params", "rms_norm",
           "layer_norm", "dense", "softcap", "rope_freqs", "apply_rope"]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | scaled
    scale: float = 1.0
    dtype: Any = None           # defaults to the model dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.logical_axes), \
            f"{self.shape} vs {self.logical_axes}"


def _materialize(spec: ParamSpec, gen: torch.Generator,
                 device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    dt = spec.dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    std = spec.scale
    if spec.init == "scaled":
        # fan-in = the first non-"layers" dim, as in the reference
        fan_in = 1
        for dim, name in zip(spec.shape, spec.logical_axes):
            if name != "layers":
                fan_in = dim
                break
        if len(spec.shape) < 2:
            fan_in = 1
        std = spec.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x.mul_(std) if std != 1.0 else x).to(dt)


def _leaves(specs: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    if isinstance(specs, ParamSpec):
        return [(prefix, specs)]
    if isinstance(specs, list):
        items = enumerate(specs)
    else:
        items = ((k, specs[k]) for k in sorted(specs))
    out = []
    for k, v in items:
        out.extend(_leaves(v, prefix + (k,)))
    return out


def _map(specs: Any, fn) -> Any:
    if isinstance(specs, ParamSpec):
        return fn(specs)
    if isinstance(specs, list):
        return [_map(v, fn) for v in specs]
    return {k: _map(specs[k], fn) for k in sorted(specs)}


def init_params(specs: Any, generator: torch.Generator,
                device: torch.device, dtype: torch.dtype = torch.float32
                ) -> Any:
    """Materialize a spec tree on ``device``, leaves drawn in sorted-path
    order from ``generator`` (a generator of that device).  The numbers
    differ from the reference's ``jax.random`` ones; tests carry the
    reference's weights over with ``models.carry``."""
    return _map(specs, lambda s: _materialize(s, generator, device, dtype))


def count_params(specs: Any) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(specs))


# ---------------------------------------------------------------------------
# layers (pure functions over param dicts)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 accumulation: K7 on the card."""
    return model_ops.rmsnorm(x, scale, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float = 1e-5
               ) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w over the last axis of x and the first of w."""
    y = torch.matmul(x, w.reshape(w.shape[0], -1))
    y = y.reshape(*x.shape[:-1], *w.shape[1:])
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].float() * freqs       # [..., seq, hd/2]
    cos = torch.cos(ang)[..., None, :]                  # [..., seq, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
