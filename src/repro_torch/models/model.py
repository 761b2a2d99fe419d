"""The language model's serving entry points (the reference's
``models/model.py``): embed -> block stack -> norm -> head.

  model_specs(cfg)        the parameter spec tree
  make_prefill_fn(cfg)    (params, batch) -> (last-position logits [B, V]
                          float32, per-layer KV caches)
  make_decode_fn(cfg)     (params, cache, batch) -> (logits [B, V], cache);
                          batch {"token": [B, 1], "pos": int}

Both functions run where ``repro_torch.set_device`` says (the card by
default; without one they raise unless the CPU was chosen), and refuse
parameters that lie elsewhere: nothing moves between the CPU and the card
quietly.  A modality prefix (``batch["prefix_emb"]``, [B, P, d]) is
concatenated ahead of the token embeddings, as in the reference.  The
loss (``make_loss_fn``, ``_chunked_nll``) comes with the training slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels import ops as _ops
from .layers import ParamSpec, softcap
from .transformer import (apply_norm, check_supported, norm_specs, run_stack,
                          stack_specs)

__all__ = ["model_specs", "make_prefill_fn", "make_decode_fn"]


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    specs: Dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "d_model"), "normal", 0.02),
        "blocks": stack_specs(cfg),
        "final_norm": norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("d_model", "vocab"), "scaled")
    return specs


def _device(params: Dict[str, Any]) -> torch.device:
    """The chosen device (raises without a card unless the CPU was
    chosen); the parameters must already lie there."""
    dev = _ops.target()
    if params["embed"].device.type != dev.type:
        raise ValueError(f"parameters lie on {params['embed'].device} but "
                         f"repro_torch runs on {dev}; move them or call "
                         f"repro_torch.set_device")
    return params["embed"].device


def _tokens(t: Any, dev: torch.device) -> torch.Tensor:
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.array(t, dtype=np.int64))
    return torch.as_tensor(t).to(device=dev, dtype=torch.long)


def _embed(params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _head(params: Dict[str, Any], x: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, w).float()
    if cfg.logit_softcap:
        logits = softcap(logits, cfg.logit_softcap)
    return logits


def _forward(params: Dict[str, Any], tokens: torch.Tensor,
             prefix_emb: Optional[torch.Tensor], cfg: ModelConfig,
             mode: str, states: Any = None, pos: Optional[int] = None
             ) -> Tuple[torch.Tensor, Any]:
    """Shared trunk: (x of the token positions [B, S, d], new states)."""
    x = _embed(params, tokens)
    P = 0
    if prefix_emb is not None:
        P = prefix_emb.shape[1]
        x = torch.cat([prefix_emb.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    if mode == "decode":
        positions = pos
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    x, new_states = run_stack(params["blocks"], x, positions, cfg, mode,
                              states)
    x = apply_norm(params["final_norm"], x, cfg)
    return x[:, P:], new_states


def make_prefill_fn(cfg: ModelConfig) -> Callable:
    check_supported(cfg)

    def prefill_fn(params, batch):
        dev = _device(params)
        prefix = batch.get("prefix_emb")
        if prefix is not None:
            prefix = torch.as_tensor(prefix).to(dev)
        x, states = _forward(params, _tokens(batch["tokens"], dev), prefix,
                             cfg, "prefill")
        return _head(params, x[:, -1:], cfg)[:, 0], states
    return prefill_fn


def make_decode_fn(cfg: ModelConfig) -> Callable:
    check_supported(cfg)

    def decode_fn(params, cache, batch):
        """batch: {"token": [B, 1] ints, "pos": int, the tokens cached}."""
        dev = _device(params)
        x, cache = _forward(params, _tokens(batch["token"], dev), None, cfg,
                            "decode", states=cache, pos=int(batch["pos"]))
        return _head(params, x, cfg)[:, 0], cache
    return decode_fn
