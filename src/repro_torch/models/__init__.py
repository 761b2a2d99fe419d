"""The model stack's serving path: layers, attention, the decoder stack
and the language model (prefill and flat or LSM-tiered decode)."""
