"""xlstm-125m: alternating mLSTM/sLSTM blocks [arXiv:2405.04517; unverified].
No FFN (d_ff=0): xLSTM blocks carry their own up/down projections.  Pure
recurrent state -> runs the long_500k cell (O(1) decode state)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, xlstm_heads=4,
    block_pattern=(("mlstm", "none"), ("slstm", "none")),
    norm_kind="layernorm", remat_policy="full", tie_embeddings=False,
)
