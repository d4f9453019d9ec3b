"""The port's serve subsystem: QueryEngine + batching planner + prefilters
+ the memory-budgeted tier (truncated rank-prefix labels under a byte
budget and its pressure governor) + the overload-safe serving daemon
(admission control, deadline shedding, circuit-broken degradation) and its
open-loop workload driver.
"""
from repro_torch.serve.budget import (
    BudgetController,
    PressureConfig,
    TruncatedStore,
    rank_cut_for_budget,
    truncate_store,
)
from repro_torch.serve.daemon import CircuitBreaker, DaemonConfig, ServeDaemon, ShedError
from repro_torch.serve.engine import (
    BACKENDS,
    QueryEngine,
    intersect_rows,
    make_hop_sharded_serve_step,
    make_sharded_serve_step,
    select_backend,
    serve_step,
)
from repro_torch.serve.openloop import check_truth, run_open_loop
from repro_torch.serve.planner import BatchPlan, TierPlan, plan_batch, tier_widths
from repro_torch.serve.prefilter import PrefilterResult, apply_prefilters, topo_levels

__all__ = [
    "BACKENDS",
    "BudgetController",
    "PressureConfig",
    "TruncatedStore",
    "rank_cut_for_budget",
    "truncate_store",
    "CircuitBreaker",
    "DaemonConfig",
    "ServeDaemon",
    "ShedError",
    "check_truth",
    "run_open_loop",
    "QueryEngine",
    "select_backend",
    "serve_step",
    "intersect_rows",
    "make_sharded_serve_step",
    "make_hop_sharded_serve_step",
    "BatchPlan",
    "TierPlan",
    "plan_batch",
    "tier_widths",
    "PrefilterResult",
    "apply_prefilters",
    "topo_levels",
]
