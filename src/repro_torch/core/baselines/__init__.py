"""Label-free reachability search: the serve engine's bottom rung."""
from repro_torch.core.baselines.online_search import OnlineBFS, bidirectional_query

__all__ = ["OnlineBFS", "bidirectional_query"]
