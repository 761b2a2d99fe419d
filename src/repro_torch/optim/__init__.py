"""Optimizers over the port's parameter trees: AdamW and error-feedback
int8 gradient compression."""
