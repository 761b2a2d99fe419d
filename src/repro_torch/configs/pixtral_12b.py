"""pixtral-12b: pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].  The ViT frontend is a STUB:
``prefix_emb`` [B, prefix_len, d] stands in for patch embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=160,
    block_pattern=(("attn", "mlp"),),
    ffn_kind="swiglu", norm_kind="rmsnorm", use_bias=False,
    rope_theta=1000000000.0, prefix_len=256, remat_policy="full",
)
