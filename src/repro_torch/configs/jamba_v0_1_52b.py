"""jamba-v0.1-52b: Mamba+attention 1:7 interleave with MoE every other layer
[arXiv:2403.19887; hf].  attn_layer_period=8 offset=4; expert_layer_period=2
offset=1; 16 experts top-2.  Hybrid -> runs the long_500k cell (only 4 of 32
layers hold KV caches)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    num_experts=16, experts_per_token=2,
    block_pattern=(
        ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
        ("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
    ),
    ffn_kind="swiglu", norm_kind="rmsnorm", use_bias=False,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    remat_policy="full",
)
