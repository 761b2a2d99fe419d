"""Guards of the PyTorch port: it imports neither jax nor the reference
package, and it never falls back from the card to the CPU quietly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_or_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_port_runs_a_query_with_jax_and_reference_blocked():
    code = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import datetime as dt
import repro_torch
repro_torch.set_device("cpu")
from repro_torch.configs.tinysocial import build_dataverse
from repro_torch.core import algebra as A
from repro_torch.storage.query import run_query
_, ds = build_dataverse(60, 300, num_partitions=2, flush_threshold=32)
lo, hi = dt.datetime(2014, 1, 10), dt.datetime(2014, 2, 10)
plan = A.aggregate(A.select(A.scan("MugshotMessages"),
                            pred=lambda r: lo <= r["timestamp"] <= hi,
                            fields=["timestamp"],
                            ranges={"timestamp": (lo, hi)}),
                   {"c": ("count", "*")})
rows, ex = run_query(plan, ds, vectorize=True)
assert ex.stats.rows_fallback == 0 and rows[0]["c"] > 0
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK", rows[0]["c"])
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("OK")


def test_entry_points_raise_without_a_card_unless_cpu_is_chosen():
    import torch
    import repro_torch
    from repro_torch.kernels import columnar_ops as K
    from repro_torch.kernels import fuzzy_ops as F
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    x = np.arange(16, dtype=np.int64)
    v = np.ones(16, bool)
    repro_torch.set_device("cuda")
    try:
        assert repro_torch.device() == "cuda"
        for call in (lambda: K.range_mask([(x, v, 1, 5)], 16),
                     lambda: K.fused_filter_aggregate([], [(x, v)], 16),
                     lambda: K.sorted_intersect_mask(x, x[::2]),
                     lambda: F.t_occurrence_mask(x, 16, 1),
                     lambda: F.edit_distances(["tpu"], "tpv", 1),
                     lambda: F.set_intersect_counts([x], [x]),
                     lambda: F.bitset_intersect_counts(
                         np.ones((2, 1), np.uint32), x[:1], x[:1])):
            with pytest.raises(RuntimeError, match="set_device"):
                call()
    finally:
        repro_torch.set_device("cpu")


def test_set_device_rejects_unknown_names():
    import repro_torch
    with pytest.raises(ValueError):
        repro_torch.set_device("tpu")


def test_run_query_refuses_a_mesh():
    """Once refused until the partition runtime (rung 4) landed: a mesh of
    n lanes now runs, and a mesh it cannot run (no lanes, or an object that
    is no ``PartitionMesh``) is refused, never ignored."""
    import repro_torch
    from repro_torch.configs.tinysocial import build_dataverse
    from repro_torch.core import algebra as A
    from repro_torch.runtime.spmd import PartitionMesh
    from repro_torch.storage.query import run_query
    repro_torch.set_device("cpu")
    _, ds = build_dataverse(10, 20, num_partitions=2, flush_threshold=8)
    plan = A.scan("MugshotUsers")
    with pytest.raises(ValueError, match="lane"):
        run_query(plan, ds, vectorize=True, mesh=0)
    with pytest.raises(TypeError, match="PartitionMesh"):
        run_query(plan, ds, vectorize=True, mesh="2")
    rows, _ = run_query(plan, ds, vectorize=True)
    mesh = PartitionMesh(2, repro_torch.kernels.ops.target())
    for m in (2, mesh):
        got, _ = run_query(plan, ds, vectorize=True, mesh=m)
        assert sorted(r["id"] for r in got) == sorted(r["id"] for r in rows)


def test_ngram_index_refused_until_fuzzy_slice():
    """Once refused until the fuzzy slice landed: an ngram index is now
    created (backfilling existing components) and probed on the CPU."""
    import repro_torch
    from repro_torch.configs.tinysocial import build_dataverse
    from repro_torch.core import algebra as A
    from repro_torch.fuzzy import fuzzy_predicate
    from repro_torch.storage.query import run_query
    repro_torch.set_device("cpu")
    _, ds = build_dataverse(10, 20, num_partitions=2, flush_threshold=8)
    ds["MugshotUsers"].create_index("name", kind="ngram")
    assert ds["MugshotUsers"].index_kinds["name"] == "ngram"
    spec = ("name", "ed", "User Number 3", 1)
    rows, ex = run_query(A.select(A.scan("MugshotUsers"),
                                  pred=fuzzy_predicate(spec),
                                  fields=["name"], fuzzy=spec), ds,
                         vectorize=True)
    assert ex.stats.rows_fallback == 0 and ex.stats.rows_fuzzy_vectorized
    assert sorted(r["id"] for r in rows) == list(range(10))


def test_model_entry_points_raise_without_a_card_unless_cpu_is_chosen():
    """The model serving path (prefill, decode, the serve launcher) runs
    on the card by default, raises without one, and runs on the CPU only
    when asked."""
    import torch
    import repro_torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = serve.build_config("deepseek-67b", kv_layout="flat")
    repro_torch.set_device("cpu")
    params = serve.make_params(cfg)
    tokens = np.zeros((1, 4), np.int64)
    _, cache = M.make_prefill_fn(cfg)(params, {"tokens": tokens})
    cache = serve.prepare_cache(cfg, cache, 8)
    step = {"token": tokens[:, :1], "pos": 4}
    argv = ["--requests", "1", "--prompt-len", "4", "--gen-tokens", "3"]
    repro_torch.set_device("cuda")
    try:
        for call in (lambda: M.make_prefill_fn(cfg)(params,
                                                    {"tokens": tokens}),
                     lambda: M.make_decode_fn(cfg)(params, cache, step),
                     lambda: serve.main(argv)):
            with pytest.raises(RuntimeError, match="set_device"):
                call()
    finally:
        repro_torch.set_device("cpu")
    out = serve.main(argv + ["--device", "cpu"])
    assert out["decode"]["tokens"].shape == (1, 3)
    logits, _ = M.make_decode_fn(cfg)(params, cache, step)
    assert logits.shape == (1, cfg.vocab_size)


@pytest.mark.parametrize("arch", ["dbrx-132b", "olmoe-1b-7b",
                                  "jamba-v0.1-52b", "xlstm-125m"])
def test_unported_blocks_raise_not_implemented(arch):
    """MoE, Mamba and xLSTM blocks come with later slices of the port."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.models.transformer import cache_specs
    cfg = reduced(get_config(arch))
    for call in (lambda: M.model_specs(cfg), lambda: M.make_prefill_fn(cfg),
                 lambda: M.make_decode_fn(cfg),
                 lambda: cache_specs(cfg, 1, 8)):
        with pytest.raises(NotImplementedError, match="slice"):
            call()


def test_training_entry_points_raise_without_a_card_unless_cpu_is_chosen(
        tmp_path):
    """The training path (the loss, the train step, the Trainer and the
    training launcher) runs on the card by default, raises without one,
    and runs on the CPU only when asked."""
    import torch
    import repro_torch
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_params
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    from repro_torch.training.trainer import Trainer
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = reduced(get_config("deepseek-67b"))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(M.model_specs(cfg), gen, torch.device("cpu"))
    opt = OptimizerConfig()
    state = init_train_state(params, opt)
    toks = np.zeros((2, 9), np.int32)
    batch = {"tokens": toks[:, :8], "labels": toks[:, 1:]}
    argv = ["--arch", "deepseek-67b", "--reduced", "--steps", "1",
            "--global-batch", "2", "--seq-len", "8", "--ckpt-dir",
            str(tmp_path), "--override", "num_layers=1"]
    repro_torch.set_device("cuda")
    try:
        for call in (lambda: M.make_loss_fn(cfg)(params, batch),
                     lambda: make_train_step(cfg, opt)(params, state, batch),
                     lambda: Trainer(cfg, global_batch=2, seq_len=8,
                                     ckpt_dir=str(tmp_path)),
                     lambda: train.main(argv)):
            with pytest.raises(RuntimeError, match="set_device"):
                call()
    finally:
        repro_torch.set_device("cpu")
    out = train.main(argv + ["--device", "cpu"])
    assert out["trainer"].step == 1
    loss, _ = M.make_loss_fn(cfg)(params, batch)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("arch", ["dbrx-132b", "olmoe-1b-7b",
                                  "jamba-v0.1-52b", "xlstm-125m"])
def test_unported_blocks_raise_not_implemented_in_train_mode(arch, tmp_path):
    """MoE, Mamba and xLSTM blocks refuse the training path too."""
    import repro_torch
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.trainer import Trainer
    repro_torch.set_device("cpu")
    cfg = reduced(get_config(arch))
    for call in (lambda: M.make_loss_fn(cfg), lambda: make_train_step(cfg),
                 lambda: Trainer(cfg, global_batch=2, seq_len=8,
                                 ckpt_dir=str(tmp_path))):
        with pytest.raises(NotImplementedError, match="slice"):
            call()
