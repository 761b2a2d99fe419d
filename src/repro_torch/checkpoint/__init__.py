"""LSM-style checkpointing of training state (``manager``)."""
