"""deepseek-67b: llama-arch dense GQA [arXiv:2401.02954; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=102400,
    block_pattern=(("attn", "mlp"),),
    ffn_kind="swiglu", norm_kind="rmsnorm", use_bias=False,
    rope_theta=10000.0, remat_policy="full",
)
