"""musicgen-large: decoder-only over EnCodec tokens [arXiv:2306.05284; hf].
The audio frontend (EnCodec) and text conditioning (T5) are STUBS: the batch
carries ``prefix_emb`` [B, prefix_len, d] of precomputed conditioning frames.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    block_pattern=(("attn", "mlp"),),
    ffn_kind="gelu_mlp", norm_kind="layernorm", use_bias=True,
    prefix_len=64, remat_policy="full",
)
