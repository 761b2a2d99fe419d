"""Fault-tolerant training loop (the reference's
``training/trainer.py``).

Wires together: feed pipeline (``data/feeds``) -> train step
(``training/train_step``) -> LSM checkpointing (``checkpoint/manager``)
with a step-metadata WAL, plus:

  * deterministic resume: the feed cursor is checkpointed with the model,
    so a restarted run consumes exactly the records the crashed run would
    have;
  * failure injection for tests (``fail_at_step``): the restarted Trainer
    recovers from the newest VALID component and replays.

It runs on the card unless ``repro_torch.set_device("cpu")`` was called;
without a card it raises on construction.  Parameters are made from a
seeded ``torch.Generator`` on the device (the reference draws them with
``jax.random``; tests carry the reference's over with
``models.carry``).  The reference's ``rules`` and ``mesh`` (elastic
restore onto another mesh) come with the port's sharding slice.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ModelConfig
from ..data.feeds import BatchAssembler, Feed, SyntheticTokenAdaptor
from ..kernels import ops as _ops
from ..models.layers import init_params
from ..models.model import model_specs
from ..optim import adamw
from .train_step import init_train_state, make_train_step

__all__ = ["Trainer", "InjectedFailure"]


class InjectedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(self, cfg: ModelConfig, *, global_batch: int, seq_len: int,
                 ckpt_dir: str,
                 opt_cfg: adamw.OptimizerConfig = adamw.OptimizerConfig(),
                 compress: bool = False, keep: int = 3,
                 param_dtype: torch.dtype = torch.float32, seed: int = 0):
        self.device = _ops.target()
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.opt_cfg = opt_cfg
        self.compress = compress
        self.param_dtype = param_dtype
        self.seed = seed
        self.ckpt = CheckpointManager(ckpt_dir, keep=keep)
        self.step_fn = make_train_step(cfg, opt_cfg, compress=compress,
                                       donate=True)
        # -- data pipeline: primary feed -> batch assembler ------------------
        self.assembler = BatchAssembler(global_batch)
        self.feed = Feed(
            name="train_feed",
            adaptor=SyntheticTokenAdaptor(seq_len, cfg.vocab_size, seed),
            store=self.assembler)
        self.params = None
        self.opt_state = None
        self.step = 0
        self.history: list = []

    # -- state init / restore -------------------------------------------------
    def init_state(self) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        self.params = init_params(model_specs(self.cfg), gen, self.device,
                                  self.param_dtype)
        self.opt_state = init_train_state(self.params, self.opt_cfg,
                                          self.compress)
        self.step = 0

    def restore(self) -> bool:
        """Resume from the newest VALID checkpoint.  Returns True if
        restored."""
        got = self.ckpt.load_latest(self.device)
        if got is None:
            return False
        step, state, extra = got
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step = step
        self.feed.restore(extra["feed"])
        self.assembler.backlog = []
        return True

    def init_or_restore(self) -> None:
        if not self.restore():
            self.init_state()

    # -- training loop --------------------------------------------------------
    def _next_batch(self) -> Dict[str, torch.Tensor]:
        while True:
            b = self.assembler.take()
            if b is not None:
                return {k: torch.from_numpy(v).to(self.device)
                        for k, v in b.items()}
            self.feed.pump(self.global_batch)

    def run(self, num_steps: int, checkpoint_every: int = 0,
            fail_at_step: Optional[int] = None,
            log_every: int = 10) -> Dict[str, Any]:
        assert self.params is not None, "call init_or_restore() first"
        t0 = time.time()
        last: Dict[str, Any] = {}
        for _ in range(num_steps):
            if fail_at_step is not None and self.step == fail_at_step:
                raise InjectedFailure(f"injected failure at step {self.step}")
            batch = self._next_batch()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            last = {k: float(v) for k, v in metrics.items()}
            self.history.append({"step": self.step, **last})
            self.ckpt.log_step({"step": self.step,
                                "feed_cursor": self.feed.cursor,
                                "loss": last.get("loss")})
            if checkpoint_every and self.step % checkpoint_every == 0:
                self.save_checkpoint()
        last["wall_s"] = time.time() - t0
        return last

    def save_checkpoint(self, crash_before_validity: bool = False) -> None:
        self.ckpt.save(
            self.step,
            {"params": self.params, "opt": self.opt_state},
            extra={"feed": self.feed.state(),
                   "config": {"arch": self.cfg.name,
                              "global_batch": self.global_batch}},
            crash_before_validity=crash_before_validity)
