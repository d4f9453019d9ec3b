"""The port's serve subsystem: QueryEngine + batching planner + prefilters
+ the memory-budgeted tier (truncated rank-prefix labels under a byte
budget and its pressure governor).

The serving daemon and open-loop driver of ``repro.serve`` are a later
slice of the port (ROADMAP.md Queue 1 item 8).
"""
from repro_torch.serve.budget import (
    BudgetController,
    PressureConfig,
    TruncatedStore,
    rank_cut_for_budget,
    truncate_store,
)
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
    "BudgetController",
    "PressureConfig",
    "TruncatedStore",
    "rank_cut_for_budget",
    "truncate_store",
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
