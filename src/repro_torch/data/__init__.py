"""Synthetic data for the substrate's models, the port of ``repro.data``."""
