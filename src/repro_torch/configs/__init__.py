"""Dataset configurations (TinySocial, the paper's running example)."""
