"""dbrx-132b: 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    num_experts=16, experts_per_token=4,
    block_pattern=(("attn", "moe"),),
    ffn_kind="swiglu", norm_kind="layernorm", use_bias=False,
    rope_theta=500000.0, remat_policy="full",
)
