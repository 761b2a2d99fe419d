"""The model stack: layers, attention, the decoder stack and the language
model (the training loss, prefill and flat or LSM-tiered decode)."""
