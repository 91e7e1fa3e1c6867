"""Synthetic data streams (``repro.data`` subset)."""
