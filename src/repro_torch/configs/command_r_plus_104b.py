"""command-r-plus-104b: dense GQA, no-bias layernorm
[hf:CohereForAI/c4ai-command-r-v01; unverified].  (Cohere's parallel
attention+FFN block is folded to sequential here; see docs/ARCHITECTURE.md
§Training-stack deviations.)"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000,
    block_pattern=(("attn", "mlp"),),
    ffn_kind="swiglu", norm_kind="layernorm", use_bias=False,
    rope_theta=75000000.0, remat_policy="full",
)
