"""The port's checkpoint manager and fault-tolerant Trainer on the CPU:
mirrors of the checkpoint half of the reference's
tests/test_feeds_checkpoint.py:123-192 (roundtrip and GC, a crash before
the validity bit, an asynchronous save, the WAL's torn tail, the
Trainer's crash recovery, here on reduced deepseek-67b in place of the
reference's olmoe, which is MoE), the port's own leaf kinds (lists of
per-layer trees, bfloat16, 0-d step counters), the Trainer against the
reference's Trainer from one carried state on the same synthetic feed,
and the training launcher."""

import dataclasses
import json
import tempfile

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.optim.adamw import OptimizerConfig, tree_leaves
from repro_torch.training.trainer import InjectedFailure, Trainer


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _state(x=1.0):
    return {"params": {"w": torch.full((4, 4), x)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip_and_gc():
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=2)
        for s in (1, 2, 3, 4):
            cm.save(s, _state(s), extra={"feed": {"cursor": s * 10}})
        assert cm.valid_steps() == [3, 4]
        step, state, extra = cm.load_latest()
        assert step == 4
        assert state["params"]["w"][0, 0] == 4.0
        assert extra["feed"]["cursor"] == 40


def test_crash_before_validity_is_invisible():
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=3)
        cm.save(1, _state(1.0), extra={})
        cm.save(2, _state(2.0), extra={}, crash_before_validity=True)
        got = cm.load_latest()
        assert got[0] == 1                      # torn component ignored...
        assert cm.valid_steps() == [1]          # ...and removed


def test_async_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=3)
        cm.save(7, _state(7.0), extra={}, asynchronous=True)
        cm.wait()
        assert cm.valid_steps() == [7]


def test_async_save_snapshots_the_state_at_the_call():
    """The leaves are copied to the host when ``save`` is called, so a
    step that updates them in place meanwhile does not leak in."""
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)
        st = _state(1.0)
        cm.save(1, st, extra={}, asynchronous=True)
        st["params"]["w"].add_(5.0)
        cm.wait()
        assert float(cm.load(1)[0]["params"]["w"].max()) == 1.0


def test_wal_torn_tail_ignored():
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)
        cm.log_step({"step": 1})
        cm.log_step({"step": 2})
        with open(cm.wal_path, "a") as f:
            f.write('{"step": 3, "loss"')      # torn write
        assert [r["step"] for r in cm.read_wal()] == [1, 2]


def test_checkpoint_keeps_lists_dtypes_and_bfloat16():
    """Per-layer lists come back as lists; a bfloat16 leaf is written as
    its 16-bit pattern with ``bfloat16`` in the manifest and comes back
    bit for bit; 0-d counters and numpy leaves keep their dtypes."""
    gen = torch.Generator()
    gen.manual_seed(5)
    bf = torch.randn(3, 5, generator=gen).to(torch.bfloat16)
    state = {"params": {"blocks": [{"w": torch.randn(2, 3, generator=gen)},
                                   {"w": bf}],
                        "embed": np.arange(6, dtype=np.int64)},
             "opt": {"step": torch.tensor(9, dtype=torch.int32)}}
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)
        path = cm.save(9, state, extra={"k": 1})
        man = json.loads((path / "manifest.json").read_text())
        kinds = {tuple(leaf["path"]): leaf["dtype"]
                 for leaf in man["leaves"]}
        assert kinds[("params", "blocks", 1, "w")] == "bfloat16"
        got, extra = cm.load(9)
        assert isinstance(got["params"]["blocks"], list)
        assert got["params"]["blocks"][1]["w"].dtype == torch.bfloat16
        assert torch.equal(got["params"]["blocks"][1]["w"], bf)
        assert torch.equal(got["params"]["blocks"][0]["w"],
                           state["params"]["blocks"][0]["w"])
        assert got["params"]["embed"].dtype == torch.int64
        assert got["opt"]["step"].dtype == torch.int32
        assert got["opt"]["step"].shape == () and int(got["opt"]["step"]) == 9
        assert extra == {"k": 1}


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=20)


def test_trainer_crash_recovery_is_deterministic():
    """Crash at step 4 of 6 with a checkpoint every 2 steps, restart: the
    resumed run's losses equal the uninterrupted run's bit for bit (the
    reference's test allows rtol 1e-4)."""
    cfg = reduced(get_config("deepseek-67b"))
    opt = OptimizerConfig(**OPT)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        t_ref = Trainer(cfg, global_batch=4, seq_len=16, ckpt_dir=d1,
                        opt_cfg=opt)
        t_ref.init_or_restore()
        t_ref.run(6)
        ref = [h["loss"] for h in t_ref.history]

        t1 = Trainer(cfg, global_batch=4, seq_len=16, ckpt_dir=d2,
                     opt_cfg=opt)
        t1.init_or_restore()
        with pytest.raises(InjectedFailure):
            t1.run(6, checkpoint_every=2, fail_at_step=4)
        t2 = Trainer(cfg, global_batch=4, seq_len=16, ckpt_dir=d2,
                     opt_cfg=opt)
        t2.init_or_restore()
        assert t2.step == 4
        assert [r["step"] for r in t2.ckpt.read_wal()] == [1, 2, 3, 4]
        t2.run(2)
        rec = [h["loss"] for h in t2.history]
        assert rec == ref[4:]
        for a, b in zip(tree_leaves(t2.params), tree_leaves(t_ref.params)):
            assert torch.equal(a, b)


def test_trainer_matches_reference_trainer():
    """The port's Trainer and the reference's, started from one carried
    state (the reference's weights, unrolled as in
    test_torch_train._step_cfgs, and its zero optimizer state), on the
    same synthetic feed: the same losses over 4 steps (rtol 1e-5)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.base import reduced as r_reduced
    from repro.configs.registry import get_config as r_get_config
    from repro.models import model as RM
    from repro.models.layers import init_params as r_init
    from repro.optim.adamw import OptimizerConfig as ROptimizerConfig
    from repro.training.train_step import init_train_state as r_state
    from repro.training.trainer import Trainer as RTrainer
    from repro_torch.models.carry import (params_from_reference,
                                          train_state_from_reference)
    rcfg, pcfg = (dataclasses.replace(c, scan_layers=False) for c in (
        r_reduced(r_get_config("deepseek-67b")),
        reduced(get_config("deepseek-67b"))))
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        rt = RTrainer(rcfg, global_batch=4, seq_len=16, ckpt_dir=d1,
                      opt_cfg=ROptimizerConfig(**OPT))
        # jitted: op by op, jax.random's draws take seconds
        rt.params = jax.jit(lambda k: r_init(RM.model_specs(rcfg), k,
                                             jnp.float32))(jax.random.key(2))
        rt.opt_state = r_state(rt.params, ROptimizerConfig(**OPT))
        pt = Trainer(pcfg, global_batch=4, seq_len=16, ckpt_dir=d2,
                     opt_cfg=OptimizerConfig(**OPT))
        cpu = torch.device("cpu")
        pt.params = params_from_reference(
            jax.tree.map(np.asarray, rt.params), pcfg, cpu)
        pt.opt_state = train_state_from_reference(
            jax.tree.map(np.asarray, rt.opt_state), pcfg, cpu)
        rt.run(4)
        pt.run(4)
        assert [h["step"] for h in pt.history] == [1, 2, 3, 4]
        np.testing.assert_allclose([h["loss"] for h in pt.history],
                                   [h["loss"] for h in rt.history],
                                   rtol=1e-5)
        assert pt.feed.cursor == rt.feed.cursor


def test_train_launcher_runs_and_resumes_on_the_cpu():
    """``launch.train`` runs its steps, saves a final checkpoint, and a
    second call with more steps resumes from it."""
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", "deepseek-67b", "--reduced", "--global-batch", "2",
                "--seq-len", "16", "--ckpt-dir", d, "--checkpoint-every",
                "2", "--device", "cpu", "--override", "num_layers=1"]
        out = train.main(argv + ["--steps", "3"])
        assert out["trainer"].step == 3 and out["cfg"].num_layers == 1
        assert np.isfinite(out["last"]["loss"])
        out = train.main(argv + ["--steps", "4"])
        assert out["trainer"].step == 4
        assert len(out["trainer"].history) == 1
