"""Architecture registry: the 10 assigned configs + the paper's own workload.

Every entry is selectable via ``--arch <id>`` in the launchers.  Cell
applicability (``long_500k`` needs sub-quadratic attention) is centralized in
``shape_applicable`` and mirrored in docs/ARCHITECTURE.md §Architecture
applicability.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .base import ModelConfig, ShapeConfig, SHAPES, validate_config

__all__ = ["ARCHS", "get_config", "list_archs", "shape_applicable",
           "applicable_cells", "OPTIMIZED_PROFILES", "optimized_config"]

# §Perf winners (EXPERIMENTS.md): per-arch beyond-paper profiles, applied
# via ``optimized_config(name)`` / ``--optimized`` in the launchers.  The
# plain configs stay paper-faithful baselines.
OPTIMIZED_PROFILES = {
    # A1+A3: sequence parallelism (MFU 0.277 -> 0.556 on train_4k/pod1)
    "command-r-plus-104b": {"seq_shard": True, "reduce_dtype": "bfloat16"},
    "deepseek-67b": {"seq_shard": True, "reduce_dtype": "bfloat16"},
    "internlm2-20b": {"seq_shard": True, "reduce_dtype": "bfloat16"},
    "pixtral-12b": {"seq_shard": True, "reduce_dtype": "bfloat16"},
    "musicgen-large": {"seq_shard": True, "reduce_dtype": "bfloat16"},
    "dbrx-132b": {"seq_shard": True, "reduce_dtype": "bfloat16"},
    "jamba-v0.1-52b": {"seq_shard": True, "reduce_dtype": "bfloat16"},
    "olmoe-1b-7b": {"seq_shard": True, "reduce_dtype": "bfloat16"},
    # B1: pure-DP/ZeRO-3 rule hint (MFU 0.020 -> 0.247); needs
    # global_batch >= chips — see EXPERIMENTS §Perf cell B (pod2 caveat)
    "starcoder2-3b": {
        "rule_hints": (("batch", ("data", "model")), ("d_ff", None),
                       ("act_ff", None), ("vocab", None)),
        "loss_chunk": 512,
    },
    "xlstm-125m": {
        "rule_hints": (("batch", ("data", "model")), ("vocab", None)),
    },
}


def optimized_config(name: str) -> ModelConfig:
    """The arch's beyond-paper §Perf profile (falls back to baseline)."""
    import dataclasses
    cfg = get_config(name)
    prof = OPTIMIZED_PROFILES.get(cfg.name, {})
    return dataclasses.replace(cfg, **prof) if prof else cfg

# id -> (module name, attribute); modules define CONFIG = ModelConfig(...)
_ARCH_MODULES = [
    "dbrx_132b", "olmoe_1b_7b", "command_r_plus_104b", "starcoder2_3b",
    "deepseek_67b", "internlm2_20b", "musicgen_large", "pixtral_12b",
    "xlstm_125m", "jamba_v0_1_52b",
]

ARCHS: Dict[str, ModelConfig] = {}


def _load() -> None:
    if ARCHS:
        return
    import importlib
    for mod_name in _ARCH_MODULES:
        mod = importlib.import_module(f"{__package__}.{mod_name}")
        cfg = validate_config(mod.CONFIG)
        ARCHS[cfg.name] = cfg


def get_config(name: str) -> ModelConfig:
    _load()
    name = name.replace("_", "-")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    _load()
    return sorted(ARCHS)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable?, reason).  Per task spec: long_500k decode requires
    sub-quadratic attention — run for SSM/hybrid, skip for pure full-attention
    archs (every assigned transformer is causal-decoder, so decode shapes
    apply to all)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("pure full-attention arch: 524288-token KV per "
                       "sequence is out of scope per task spec; noted in "
                       "docs/ARCHITECTURE.md §Architecture applicability")
    return True, ""


def applicable_cells() -> List[Tuple[str, str]]:
    """All (arch, shape) dry-run cells that must pass."""
    _load()
    cells = []
    for a, cfg in sorted(ARCHS.items()):
        for s, shape in SHAPES.items():
            ok, _ = shape_applicable(cfg, shape)
            if ok:
                cells.append((a, s))
    return cells
