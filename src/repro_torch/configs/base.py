"""Model/run configuration records.

Configs are *closed* ADM record types (core/adm.py): unknown fields are
rejected at validation time, reproducing AsterixDB's closed-Datatype
semantics.  Experiment overlays may use ``open_overrides`` to carry extra
instance-level fields (open-type semantics) without widening the schema.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ..core import adm

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "RunConfig",
           "validate_config", "reduced"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    ffn_kind: str = "swiglu"         # swiglu | gelu_mlp
    use_bias: bool = False
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    moe_dispatch: str = "einsum"     # einsum | sort (hash-partition hillclimb)
    kv_layout: str = "flat"          # flat | tiered (LSM components, paper C3)
    kv_tail_cap: int = 256           # tiered: memtable capacity
    kv_l1_comps: int = 4             # tiered: L1 ring slots
    # --- block pattern: tuple of (mixer, ffn) pairs cycled over layers.
    # mixer in {attn, mamba, mlstm, slstm}; ffn in {mlp, moe, none}
    block_pattern: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)
    # --- SSM (mamba) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 -> ceil(d_model/16)
    # --- xLSTM ---
    xlstm_heads: int = 4
    # --- modality frontend stubs ---
    prefix_len: int = 0              # vlm/audio: precomputed-embedding prefix
    # --- numerics / scan ---
    seq_chunk: int = 128             # recurrent-block time chunk (remat unit)
    attn_chunk: int = 1024           # flash KV-block for the XLA path
    remat_policy: str = "nothing"    # nothing | dots | full
    scan_layers: bool = True
    # --- beyond-paper perf levers (EXPERIMENTS.md §Perf) ---
    seq_shard: bool = False          # Megatron-style sequence parallelism
    reduce_dtype: str = "float32"    # collective dtype of out-proj psums
    loss_chunk: int = 0              # chunked cross-entropy (0 = off)
    # per-arch sharding hints (paper §5.1 / Query 14's hint mechanism):
    # ((logical_axis, mesh_axes), ...) overriding the safe-rule table
    rule_hints: Tuple[Tuple[str, Any], ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def layer_pattern(self) -> Tuple[Tuple[str, str], ...]:
        p = self.block_pattern
        if self.num_layers % len(p) != 0:
            raise ValueError(
                f"{self.name}: block_pattern period {len(p)} must divide "
                f"num_layers {self.num_layers}")
        return p

    def params_per_token_active(self) -> int:
        """N_active for MODEL_FLOPS = 6*N_active*D (MoE counts top-k only)."""
        return _count_params(self, active_only=True)

    def params_total(self) -> int:
        return _count_params(self, active_only=False)


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n = cfg.vocab_size * d                       # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * d                  # lm head
    per = len(cfg.layer_pattern)
    cycles = cfg.num_layers // per
    for mixer, ffn in cfg.layer_pattern:
        if mixer == "attn":
            n_l = d * (cfg.num_heads * hd) + d * (2 * cfg.num_kv_heads * hd) \
                + (cfg.num_heads * hd) * d
        elif mixer == "mamba":
            di, st, dtr = cfg.ssm_inner, cfg.ssm_state, cfg.resolved_dt_rank
            n_l = d * 2 * di + di * cfg.ssm_conv + di * (dtr + 2 * st) \
                + dtr * di + di * st + di + di * d
        elif mixer == "mlstm":
            di = 2 * d
            # up + conv + qkv + if-gates + ln + down
            n_l = d * 2 * di + cfg.ssm_conv * di + di + 3 * di * di \
                + di * 2 * cfg.xlstm_heads + 2 * cfg.xlstm_heads + di \
                + di * d
        elif mixer == "slstm":
            dh = d // cfg.xlstm_heads
            # fused 4-gate input weights + bias + block-diag recurrent + ln
            n_l = d * 4 * d + 4 * d + 4 * cfg.xlstm_heads * dh * dh + d
        else:
            raise ValueError(mixer)
        if ffn == "mlp":
            mult = 3 if cfg.ffn_kind == "swiglu" else 2
            n_l += mult * d * cfg.d_ff
        elif ffn == "moe":
            e = cfg.experts_per_token if active_only else cfg.num_experts
            n_l += 3 * d * cfg.d_ff * e + d * cfg.num_experts
        n += n_l * cycles
    return n


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set — all 10 archs share it)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    dtype: str = "bfloat16"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_accum: int = 1
    grad_compression: bool = False
    seed: int = 0
    open_overrides: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# ADM validation of configs (closed-type semantics)
# ---------------------------------------------------------------------------

def _model_config_adm() -> adm.RecordType:
    fields = []
    for f in dataclasses.fields(ModelConfig):
        t = {int: adm.INT64, str: adm.STRING, float: adm.DOUBLE,
             bool: adm.BOOLEAN}.get(f.type if isinstance(f.type, type) else
                                    {"int": int, "str": str, "float": float,
                                     "bool": bool}.get(str(f.type), str),
                                    adm.STRING)
        has_default = (f.default is not dataclasses.MISSING
                       or f.default_factory is not dataclasses.MISSING)  # type: ignore
        fields.append(adm.Field(f.name, t, optional=has_default))
    return adm.RecordType("ModelConfig", tuple(fields), open=False)


_MODEL_CONFIG_TYPE = None


def validate_config(cfg: ModelConfig) -> ModelConfig:
    """Closed-record validation + arithmetic sanity checks."""
    global _MODEL_CONFIG_TYPE
    if _MODEL_CONFIG_TYPE is None:
        _MODEL_CONFIG_TYPE = _model_config_adm()
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d = {k: (v if not isinstance(v, tuple) else None) for k, v in d.items()}
    _MODEL_CONFIG_TYPE.validate({k: v for k, v in d.items() if v is not None})
    assert cfg.num_heads % max(cfg.num_kv_heads, 1) == 0, \
        f"{cfg.name}: heads {cfg.num_heads} not a multiple of kv {cfg.num_kv_heads}"
    _ = cfg.layer_pattern
    return cfg


def reduced(cfg: ModelConfig, *, layers: Optional[int] = None) -> ModelConfig:
    """Smoke-test configs: same family/pattern, tiny dims (paper's 'reduced
    config of the same family')."""
    per = len(cfg.layer_pattern)
    nl = layers or (2 * per if 2 * per <= 8 else per)
    nl = max(per, (nl // per) * per)
    kv = min(cfg.num_kv_heads, 2)
    heads = max(2, 4 // max(1, 4 // max(cfg.num_heads, 1)))
    heads = 4 if cfg.num_heads >= 4 else cfg.num_heads
    heads = heads - heads % kv if heads % kv else heads
    return dataclasses.replace(
        cfg,
        num_layers=nl,
        d_model=64,
        num_heads=max(heads, kv),
        num_kv_heads=kv,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=8,
        ssm_dt_rank=8,
        xlstm_heads=2,
        prefix_len=min(cfg.prefix_len, 8),
        seq_chunk=16,
        attn_chunk=32,
    )
