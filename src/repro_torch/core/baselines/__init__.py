"""Every approach the paper's §6 compares against (Table 2-7 columns), and
the serve engine's bottom rung (label-free bidirectional search).

All are host reference implementations with a common duck-typed interface:
  build(g) -> index object with .query(u, v) -> bool and .index_size_ints
"""
from repro_torch.core.baselines.online_search import OnlineBFS, bidirectional_query
from repro_torch.core.baselines.grail import Grail
from repro_torch.core.baselines.interval import IntervalTC
from repro_torch.core.baselines.pwah import PWAHBitvector
from repro_torch.core.baselines.twohop import TwoHopSetCover
from repro_torch.core.baselines.kreach import KReach

__all__ = ["OnlineBFS", "bidirectional_query", "Grail", "IntervalTC", "PWAHBitvector",
           "TwoHopSetCover", "KReach"]
