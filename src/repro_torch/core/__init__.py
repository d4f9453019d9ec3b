"""The port's oracle core: the label container, Distribution-Labeling, the
vertex orders, and the one-call API that serves on the card."""
from repro_torch.core.api import CondensedOracle, build_oracle
from repro_torch.core.oracle import ReachabilityOracle, finalize_labels, oracle_from_arrays
from repro_torch.core.distribution import distribution_labeling
from repro_torch.core.order import get_order
from repro_torch.serve.engine import QueryEngine, intersect_rows, select_backend, serve_step

__all__ = [
    "QueryEngine",
    "select_backend",
    "CondensedOracle",
    "build_oracle",
    "ReachabilityOracle",
    "finalize_labels",
    "oracle_from_arrays",
    "distribution_labeling",
    "get_order",
    "serve_step",
    "intersect_rows",
]
