"""olmoe-1b-7b: 64-expert top-8 MoE [arXiv:2409.02060; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    num_experts=64, experts_per_token=8,
    block_pattern=(("attn", "moe"),),
    ffn_kind="swiglu", norm_kind="rmsnorm", use_bias=False,
    rope_theta=10000.0, remat_policy="full",
)
