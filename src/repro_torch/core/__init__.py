"""Core: the paper's contribution adapted to JAX (ADM types, Algebricks-style
algebra + rewriter, LSM component framework)."""
