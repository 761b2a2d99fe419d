"""internlm2-20b: dense GQA [arXiv:2403.17297; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544,
    block_pattern=(("attn", "mlp"),),
    ffn_kind="swiglu", norm_kind="rmsnorm", use_bias=False,
    rope_theta=1000000.0, remat_policy="full",
)
