"""Construction engine of the port (``engine``: the reference
Distribution-Labeling build; ``traverse``: its scalar pruned BFS)."""
from repro_torch.build.engine import build_distribution_labels

__all__ = ["build_distribution_labels"]
