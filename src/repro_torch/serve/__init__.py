"""The port's serve subsystem: QueryEngine + batching planner + prefilters.

The serving daemon, open-loop driver and memory-budget tier of
``repro.serve`` are later slices of the port (ROADMAP.md Queue 1 items 7-8).
"""
from repro_torch.serve.engine import (
    BACKENDS,
    QueryEngine,
    intersect_rows,
    select_backend,
    serve_step,
)
from repro_torch.serve.planner import BatchPlan, TierPlan, plan_batch, tier_widths
from repro_torch.serve.prefilter import PrefilterResult, apply_prefilters, topo_levels

__all__ = [
    "BACKENDS",
    "QueryEngine",
    "select_backend",
    "serve_step",
    "intersect_rows",
    "BatchPlan",
    "TierPlan",
    "plan_batch",
    "tier_widths",
    "PrefilterResult",
    "apply_prefilters",
    "topo_levels",
]
