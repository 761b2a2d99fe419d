"""Carry the reference's model parameters and decode states into the
port's layout, so both packages compute from the same weights.

The reference keeps its block parameters (and decode states) under
``blocks/pos{i}`` with a leading ``layers`` axis of one entry per cycle of
the block pattern when it scans (``scan_layers`` and more than one cycle),
under ``cycle{c}/pos{i}`` when it unrolls, and bare under ``pos{i}`` for a
single cycle.  ``jax.lax.scan`` walks that axis in order, so layer
``c * period + i`` is entry ``c`` of ``pos{i}``; the port keeps one entry
per layer in that order.

Inputs are trees of numpy arrays (``jax.tree.map(np.asarray, tree)``);
nothing here imports the reference.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..configs.base import ModelConfig

__all__ = ["params_from_reference", "states_from_reference",
           "train_state_from_reference"]


def _take(tree: Any, c: int) -> Any:
    if isinstance(tree, dict):
        return {k: _take(v, c) for k, v in tree.items()}
    return tree[c]


def _per_layer(tree: Dict[str, Any], cfg: ModelConfig) -> List[Any]:
    """``blocks``-shaped tree -> one subtree per layer, in scan order."""
    per = len(cfg.layer_pattern)
    cycles = cfg.num_layers // per
    out = []
    for c in range(cycles):
        for i in range(per):
            if cycles == 1:
                out.append(tree[f"pos{i}"])
            elif cfg.scan_layers:
                out.append(_take(tree[f"pos{i}"], c))
            else:
                out.append(tree[f"cycle{c}"][f"pos{i}"])
    return out


def _to_torch(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def params_from_reference(tree: Dict[str, Any], cfg: ModelConfig,
                          device: torch.device) -> Dict[str, Any]:
    """The reference's ``init_params(model_specs(cfg), ...)`` tree (numpy
    leaves) -> the port's parameter tree on ``device``."""
    out = {k: _to_torch(v, device) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = [_to_torch(t, device)
                     for t in _per_layer(tree["blocks"], cfg)]
    return out


def states_from_reference(tree: Dict[str, Any], cfg: ModelConfig,
                          device: torch.device) -> List[Dict[str, Any]]:
    """A reference prefill or decode state tree (numpy leaves) -> the
    port's per-layer states; 0-d counters become host ints."""
    layers = []
    for t in _per_layer(tree, cfg):
        layers.append({k: int(v) if np.ndim(v) == 0 else
                       torch.from_numpy(np.array(v)).to(device)
                       for k, v in t.items()})
    return layers


def train_state_from_reference(opt_state: Dict[str, Any], cfg: ModelConfig,
                               device: torch.device) -> Dict[str, Any]:
    """The reference's optimizer state (``init_train_state``'s tree, numpy
    leaves: ``m``, ``v`` and, with compression, ``ef_err`` shaped like the
    parameters; ``step`` a scalar) -> the port's, the parameter-shaped
    trees unstacked as ``params_from_reference`` unstacks the weights and
    ``step`` a 0-d int32 tensor on ``device``."""
    out = {k: params_from_reference(opt_state[k], cfg, device)
           for k in ("m", "v", "ef_err") if k in opt_state}
    out["step"] = torch.tensor(int(np.asarray(opt_state["step"])),
                               dtype=torch.int32, device=device)
    return out
