"""starcoder2-3b: dense GQA(kv=2), RoPE, gelu MLP with bias
[arXiv:2402.19173; hf].  kv=2 < model-axis 16: the safe sharding rule
replicates KV heads (docs/ARCHITECTURE.md §Architecture applicability)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    block_pattern=(("attn", "mlp"),),
    ffn_kind="gelu_mlp", norm_kind="layernorm", use_bias=True,
    rope_theta=100000.0, remat_policy="full",
)
