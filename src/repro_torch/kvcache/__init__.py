"""The LSM-tiered decode KV cache (the paper's C3)."""
