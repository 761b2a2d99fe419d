"""The language model's entry points (the reference's
``models/model.py``): embed -> block stack -> norm -> head -> loss.

  model_specs(cfg)        the parameter spec tree
  make_loss_fn(cfg)       (params, batch) -> (loss, metrics): mean token
                          NLL (chunked over the sequence when
                          ``cfg.loss_chunk``), metrics nll, accuracy, loss;
                          batch {"tokens", "labels" [B, S], optional
                          "loss_mask" [B, S] and "prefix_emb"}
  make_prefill_fn(cfg)    (params, batch) -> (last-position logits [B, V]
                          float32, per-layer KV caches)
  make_decode_fn(cfg)     (params, cache, batch) -> (logits [B, V], cache);
                          batch {"token": [B, 1], "pos": int}

Each function runs where ``repro_torch.set_device`` says (the card by
default; without one they raise unless the CPU was chosen), and refuses
parameters that lie elsewhere: nothing moves between the CPU and the card
quietly.  A modality prefix (``batch["prefix_emb"]``, [B, P, d]) is
concatenated ahead of the token embeddings, as in the reference; the loss
is taken on the token positions only.  The loss is differentiable in the
parameters (autograd, K7's and K8's backward kernels on the card).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as _ops
from .layers import ParamSpec, softcap
from .transformer import (apply_norm, check_supported, norm_specs, run_stack,
                          stack_specs)

__all__ = ["model_specs", "make_loss_fn", "make_prefill_fn",
           "make_decode_fn", "cross_entropy"]


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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token NLL and accuracy.  logits: [B, S, V] float32; labels:
    [B, S]; mask: [B, S] weights (all ones when None)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - gold
    acc = (logits.argmax(dim=-1) == labels).float()
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom, (acc * mask).sum() / denom


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


def _chunked_nll(params: Dict[str, Any], x: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without the full [B, S, V] float32 logits: a loop
    over sequence chunks of ``cfg.loss_chunk`` (the reference scans them),
    the sequence zero-padded to a whole number of chunks with mask 0."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    B, S, _ = x.shape
    c = cfg.loss_chunk
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    nll_s, acc_s, cnt = zero, zero, zero
    for i in range(0, x.shape[1], c):
        xb, lb, mb = x[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c]
        logits = torch.matmul(xb, w).float()
        if cfg.logit_softcap:
            logits = softcap(logits, cfg.logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lb[..., None])[..., 0]
        hit = (logits.argmax(dim=-1) == lb).float()
        nll_s = nll_s + ((lse - gold) * mb).sum()
        acc_s = acc_s + (hit * mb).sum()
        cnt = cnt + mb.sum()
    cnt = torch.clamp(cnt, min=1.0)
    return nll_s / cnt, acc_s / cnt


def _mask(m: Any, dev: torch.device) -> Optional[torch.Tensor]:
    if m is None:
        return None
    if isinstance(m, np.ndarray):
        m = torch.from_numpy(np.asarray(m, dtype=np.float32))
    return torch.as_tensor(m).to(device=dev, dtype=torch.float32)


def make_loss_fn(cfg: ModelConfig) -> Callable:
    check_supported(cfg)

    def loss_fn(params, batch) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor]]:
        dev = _device(params)
        prefix = batch.get("prefix_emb")
        if prefix is not None:
            prefix = torch.as_tensor(prefix).to(dev)
        x, _ = _forward(params, _tokens(batch["tokens"], dev), prefix, cfg,
                        "train")
        labels = _tokens(batch["labels"], dev)
        mask = _mask(batch.get("loss_mask"), dev)
        if cfg.loss_chunk:
            nll, acc = _chunked_nll(
                params, x, labels,
                torch.ones_like(labels, dtype=torch.float32)
                if mask is None else mask, cfg)
        else:
            nll, acc = cross_entropy(_head(params, x, cfg), labels, mask)
        # the MoE blocks' auxiliary losses come with the MoE slice
        return nll, {"nll": nll, "accuracy": acc, "loss": nll}
    return loss_fn


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
