"""AdamW with decoupled weight decay, global-norm clipping and a
warmup + cosine schedule (the reference's ``optim/adamw.py``): functions
over parameter trees (dicts and lists of tensors, the port's layout).

It is not ``torch.optim.AdamW``.  As the reference's, it clips every
gradient by the global norm of all of them, evaluates the schedule at
``step + 1``, decays only leaves with two or more dimensions, and runs
the update in float32, casting the new parameters back to each leaf's
dtype; the moments ``m`` and ``v`` are float32.  ``update`` returns new
tensors unless ``donate`` is set: then it writes the new parameters and
moments into the tensors it was given (the counterpart of the
reference's donated buffers), which keeps a full-width step within the
card's memory.  The arithmetic is the same either way.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

__all__ = ["OptimizerConfig", "schedule", "init", "update", "global_norm",
           "tree_leaves", "tree_map"]


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 200
    decay_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0


# ---------------------------------------------------------------------------
# trees: dicts (in sorted key order) and lists of tensors
# ---------------------------------------------------------------------------

def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def schedule(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio * peak_lr``, in
    float32 at ``step`` (a 0-d tensor or an int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


_CHUNK = 1 << 26                # elements squared at a time (256 MB)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the float32 sum over leaves (in tree order) of each leaf's
    sum of squares.  A leaf's sum accumulates in float64 and is rounded to
    float32 once: XLA's float32 reduction is that accurate (a float32 dot
    or running sum over 10^6 elements drifts by 1e-5), and chunks bound
    the squares held at once."""
    total = None
    for x in tree_leaves(tree):
        f = x.reshape(-1)
        sq = sum(torch.sum(torch.square(c.to(torch.float32)),
                           dtype=torch.float64) for c in f.split(_CHUNK))
        sq = torch.as_tensor(sq, device=f.device).to(torch.float32)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
          v: torch.Tensor, clip: torch.Tensor, lr: torch.Tensor,
          b1c: torch.Tensor, b2c: torch.Tensor, cfg: OptimizerConfig
          ) -> None:
    """One leaf's update, written into p, m and v, in the reference's
    order of operations."""
    g = g.to(torch.float32) * clip
    t = g * (1 - cfg.b1)
    m.mul_(cfg.b1).add_(t)                     # b1 m + (1 - b1) g
    t = g * (1 - cfg.b2)
    t.mul_(g)
    v.mul_(cfg.b2).add_(t)                     # b2 v + (1 - b2) g g
    del g
    t = v / b2c
    t.sqrt_().add_(cfg.eps)
    upd = m / b1c
    upd.div_(t)                                # (m / b1c) / (sqrt + eps)
    del t
    if p.dim() >= 2:                           # decay matrices only
        upd.add_(p.to(torch.float32) * cfg.weight_decay)
    upd.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(upd)
    else:
        p.copy_((p.to(torch.float32) - upd).to(p.dtype))


def update(grads: Any, state: Dict[str, Any], params: Any,
           cfg: OptimizerConfig, donate: bool = False
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics) with
    metrics grad_norm (before clipping), lr and param_norm (of the new
    parameters), 0-d float32 tensors.  With ``donate`` the new values are
    written into ``params``, ``state["m"]`` and ``state["v"]``."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.max_grad_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    step = state["step"] + 1
    lr = schedule(step, cfg)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    copy = (lambda t: t) if donate else (lambda t: t.clone())
    new_params = tree_map(copy, params)
    m, v = tree_map(copy, state["m"]), tree_map(copy, state["v"])
    for p, g, mm, vv in zip(tree_leaves(new_params), tree_leaves(grads),
                            tree_leaves(m), tree_leaves(v)):
        _leaf(p, g, mm, vv, clip, lr, b1c, b2c, cfg)
    metrics = {"grad_norm": gnorm, "lr": lr,
               "param_norm": global_norm(new_params)}
    return new_params, {"m": m, "v": v, "step": step}, metrics
