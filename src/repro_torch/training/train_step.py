"""Train and serve step factories (the reference's
``training/train_step.py``).

  init_train_state(params, opt_cfg, compress)
                      AdamW state (and the error-feedback residuals)
  make_train_step(cfg, opt_cfg, grad_accum, compress, donate)
                      step(params, opt_state, batch)
                        -> (params, opt_state, metrics)
  value_and_grad(loss_fn, params, batch)
                      (loss, metrics, gradient tree) by autograd
  make_serve_steps(cfg)
                      (prefill, decode), the model's serving entry points

The reference builds a step for ``jax.jit`` with a sharding rule table;
on one card there is nothing to shard, so the port's factories take no
``rules`` (they come with ``runtime/{mesh,sharding}``).  Gradients come
from autograd over the parameter tree, through K7's and K8's backward
kernels on the card.  With ``grad_accum`` > 1 the batch's leading axis is
split into that many microbatches whose float32 gradients and metrics
are averaged, as the reference's scan does.  ``donate`` lets the step
write the new parameters and optimizer state into the ones it was given
(the reference's Trainer donates them to the jitted step).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.model import make_decode_fn, make_loss_fn, make_prefill_fn
from ..optim import adamw
from ..optim.adamw import tree_leaves, tree_map
from ..optim.grad_compress import ef_quantize, ef_state

__all__ = ["make_train_step", "make_serve_steps", "init_train_state",
           "value_and_grad"]

METRICS = ("loss", "nll", "accuracy")


def init_train_state(params: Any, opt_cfg: adamw.OptimizerConfig,
                     compress: bool = False) -> Dict[str, Any]:
    state = adamw.init(params)
    if compress:
        state["ef_err"] = ef_state(params)
    return state


def value_and_grad(loss_fn: Callable, params: Any, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, grads): autograd of ``loss_fn(params, batch)``
    with respect to every leaf of ``params`` (views of the leaves record
    the graph, so nothing is copied and the caller's tensors are left as
    they were)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(tracked, batch)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _micro(batch: Dict[str, Any], n: int, i: int) -> Dict[str, Any]:
    """Microbatch i of n: rows [i B / n, (i + 1) B / n) of every entry."""
    out = {}
    for k, x in batch.items():
        b = x.shape[0] // n
        out[k] = x[i * b:(i + 1) * b]
    return out


def make_train_step(cfg: ModelConfig,
                    opt_cfg: adamw.OptimizerConfig = adamw.OptimizerConfig(),
                    grad_accum: int = 1, compress: bool = False,
                    donate: bool = False) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics 0-d tensors: loss, nll, accuracy, grad_norm, lr,
    param_norm."""
    loss_fn = make_loss_fn(cfg)

    def compute_grads(params, batch):
        if grad_accum == 1:
            _, metrics, grads = value_and_grad(loss_fn, params, batch)
            return grads, {k: metrics[k] for k in METRICS}
        acc, msum = None, None
        for i in range(grad_accum):
            _, metrics, grads = value_and_grad(
                loss_fn, params, _micro(batch, grad_accum, i))
            if acc is None:
                acc = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
                msum = {k: torch.zeros((), dtype=torch.float32,
                                       device=metrics[k].device)
                        for k in METRICS}
            acc = tree_map(lambda a, g: a + g.to(torch.float32) / grad_accum,
                           acc, grads)
            msum = {k: msum[k] + metrics[k] / grad_accum for k in METRICS}
        return acc, msum

    def train_step(params, opt_state, batch):
        grads, metrics = compute_grads(params, batch)
        if compress:
            grads, new_err = ef_quantize(grads, opt_state["ef_err"])
        new_params, new_opt, opt_metrics = adamw.update(
            grads, {k: opt_state[k] for k in ("m", "v", "step")}, params,
            opt_cfg, donate=donate)
        if compress:
            new_opt["ef_err"] = new_err
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step


def make_serve_steps(cfg: ModelConfig) -> Tuple[Callable, Callable]:
    """(prefill_step, decode_step) for the serving path."""
    return make_prefill_fn(cfg), make_decode_fn(cfg)
