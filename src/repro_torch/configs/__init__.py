"""Dataset and model configurations: TinySocial (the paper's running
example) and the model architectures of the registry."""
