"""Recommendation models of the port: xDeepFM."""
from repro_torch.models.recsys import xdeepfm

__all__ = ["xdeepfm"]
