"""Training launcher (the reference's ``launch/train.py``):
``python -m repro_torch.launch.train --arch <id> ...``.

Drives the checkpointed ``Trainer``: restart the same command after a
crash and it resumes from the newest VALID checkpoint component with a
deterministic data cursor.  Runs on the card unless ``--device cpu`` is
given.  ``--reduced`` takes the arch's smoke-scale config (as in the
reference, off by default: the published widths); ``--override
field=json`` changes any ``ModelConfig`` field, e.g. ``--override
num_layers=2`` to cut the depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional

from ..configs.base import reduced
from ..configs.registry import get_config
from ..kernels import ops as _ops
from ..optim.adamw import OptimizerConfig
from ..training.trainer import Trainer

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--ckpt-dir", default="repro_ckpt")
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                   default=False, help="smoke-scale config")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--compress", action="store_true",
                   help="int8 error-feedback gradient compression")
    p.add_argument("--override", action="append", default=[],
                   help="ModelConfig field=json overrides")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    _ops.set_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    print(f"arch={cfg.name} params~{cfg.params_total() / 1e6:.1f}M "
          f"device={_ops.target()}")
    tr = Trainer(cfg, global_batch=args.global_batch, seq_len=args.seq_len,
                 ckpt_dir=args.ckpt_dir, compress=args.compress,
                 opt_cfg=OptimizerConfig(peak_lr=args.lr,
                                         decay_steps=args.steps))
    tr.init_or_restore()
    if tr.step:
        print(f"resumed from checkpoint at step {tr.step}")
    out = tr.run(args.steps - tr.step,
                 checkpoint_every=args.checkpoint_every)
    tr.save_checkpoint()
    print(f"done at step {tr.step}: loss={out.get('loss', float('nan')):.4f} "
          f"wall={out['wall_s']:.1f}s")
    return {"cfg": cfg, "trainer": tr, "last": out}


if __name__ == "__main__":
    main()
