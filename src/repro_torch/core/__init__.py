"""The port's oracle core: the label container, Distribution-Labeling,
Hierarchical-Labeling with its backbone, the vertex orders, and the
one-call API that serves on the card.  The paper's §6 baselines are in
``repro_torch.core.baselines``."""
from repro_torch.core.api import CondensedOracle, build_oracle, oracle_from_snapshot
from repro_torch.core.oracle import ReachabilityOracle, finalize_labels, oracle_from_arrays
from repro_torch.core.distribution import distribution_labeling
from repro_torch.core.distribution_device import distribution_labeling_torch
from repro_torch.core.hierarchy import decompose, hierarchical_labeling
from repro_torch.core.backbone import fast_cover, one_side_backbone
from repro_torch.core.order import get_order
from repro_torch.serve.engine import QueryEngine, intersect_rows, select_backend, serve_step

__all__ = [
    "QueryEngine",
    "select_backend",
    "CondensedOracle",
    "build_oracle",
    "oracle_from_snapshot",
    "ReachabilityOracle",
    "finalize_labels",
    "oracle_from_arrays",
    "distribution_labeling",
    "distribution_labeling_torch",
    "hierarchical_labeling",
    "decompose",
    "one_side_backbone",
    "fast_cover",
    "get_order",
    "serve_step",
    "intersect_rows",
]
