"""Synthetic data for the LM substrate (``repro.data``)."""
