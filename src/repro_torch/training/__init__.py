"""Training: the train and serve step factories and the checkpointed,
fault-tolerant ``Trainer``."""
