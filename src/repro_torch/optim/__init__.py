"""Optimizers of the LM training path (``repro.optim`` subset)."""
