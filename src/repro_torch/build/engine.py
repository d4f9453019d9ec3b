"""Distribution-Labeling construction engine (paper §5, Algorithm 2).

The port's construction engine, held byte for byte against
``repro.build.engine``.  It carries the reference path:

``impl="reference"``
    The scalar path: per-vertex pruned BFS with python sets + deque (via
    ``traverse.pruned_bfs_distribute``), finalized into rank-space label
    matrices.  Its labels are byte-identical to every implementation of
    the JAX package (``reference``, ``wave``, ``speculative``, ``device``),
    the contract those engines keep among themselves, so building with the
    port changes no verdict.

``impl="auto"`` resolves to ``"reference"`` here and records that in
``build_stats["impl"]``.  The batched engines are still to be ported and
raise ``NotImplementedError`` naming their ROADMAP.md item: the host
``wave`` and ``speculative`` engines (Queue 1 item 3) and the device wave
engine with its frontier kernel (Queue 1 item 4, Queue 2 K2).

Every oracle built here carries the same ``build_stats`` breadcrumb as the
JAX engine's: ``{"impl", "scheduler", "schedule_seconds", "sweep_seconds",
"n_waves", "stages", "stage_shares"}``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.build.traverse import pruned_bfs_distribute
from repro_torch.core.oracle import ReachabilityOracle, finalize_labels
from repro_torch.core.order import get_order
from repro_torch.graph.csr import CSRGraph
from repro_torch.obs import metrics, trace
from repro_torch.obs.state import ON

_NOT_PORTED = {
    "wave": "ROADMAP.md Queue 1 item 3 (host wave engine)",
    "bitset": "ROADMAP.md Queue 1 item 3 (host wave engine)",
    "speculative": "ROADMAP.md Queue 1 item 3 (host speculative engine)",
    "device": "ROADMAP.md Queue 1 item 4 (device wave engine, Queue 2 K2)",
}

_M_STAGE_SECONDS = metrics.counter(
    "build_stage_seconds_total", "cumulative construction seconds by stage",
    labelnames=("stage",))


def build_distribution_labels(
    g: CSRGraph,
    order: Optional[np.ndarray] = None,
    order_name: str = "degree_product",
    impl: str = "auto",
) -> ReachabilityOracle:
    """Build the DL oracle for DAG ``g`` with the selected implementation."""
    if impl in _NOT_PORTED:
        raise NotImplementedError(
            f"construction impl {impl!r} is not ported yet: {_NOT_PORTED[impl]}")
    if impl not in ("auto", "reference", "ref"):
        raise ValueError(f"unknown construction impl {impl!r}")
    impl = "reference"
    if order is None:
        order = get_order(g, order_name)
    order = np.asarray(order, dtype=np.int64)
    sweep_sp = (trace.span("build.sweep", cat="build",
                           args={"impl": impl, "n": g.n})
                if ON.enabled else trace.NOOP_SPAN)
    t0 = time.perf_counter()
    with sweep_sp:
        oracle = _build_reference(g, order)
    t_sweep = time.perf_counter() - t0
    object.__setattr__(oracle, "build_impl", impl)
    stages = {"schedule": 0.0, "sweep": t_sweep}
    stats = {
        "impl": impl,
        "scheduler": None,
        "schedule_seconds": 0.0,
        "sweep_seconds": round(t_sweep, 4),
        "n_waves": None,
        "stages": {k: round(float(v), 4) for k, v in sorted(stages.items())},
        "stage_shares": {
            k: (round(float(v) / t_sweep, 4) if t_sweep > 0 else 0.0)
            for k, v in sorted(stages.items())
        },
    }
    for k, v in stages.items():
        _M_STAGE_SECONDS.labels(stage=k).inc(float(v))
    object.__setattr__(oracle, "build_stats", stats)
    return oracle


def _build_reference(g: CSRGraph, order: np.ndarray) -> ReachabilityOracle:
    n = g.n
    g_rev = g.reverse()

    # Python sets give C-speed isdisjoint (the pruning hot path); parallel
    # lists keep insertion order for the final packed arrays.
    L_out_sets = [set() for _ in range(n)]
    L_in_sets = [set() for _ in range(n)]
    L_out_lists: list[list[int]] = [[] for _ in range(n)]
    L_in_lists: list[list[int]] = [[] for _ in range(n)]

    visited = np.full(n, -1, dtype=np.int64)  # iteration stamp, avoids clearing

    for it, vi in enumerate(order):
        vi = int(vi)
        # reverse BFS: distribute vi into L_out of its ancestors
        pruned_bfs_distribute(
            g_rev.indptr, g_rev.indices, vi, L_in_sets[vi],
            L_out_sets, L_out_lists, visited, 2 * it,
        )
        # forward BFS: distribute vi into L_in of its descendants
        pruned_bfs_distribute(
            g.indptr, g.indices, vi, L_out_sets[vi],
            L_in_sets, L_in_lists, visited, 2 * it + 1,
        )

    return finalize_labels(L_out_lists, L_in_lists, hop_rank=_hop_rank(order, n))


def _hop_rank(order: np.ndarray, n: int) -> np.ndarray:
    """rank[order[i]] = i — the rank-space remap shared by all impls."""
    hop_rank = np.empty(n, dtype=np.int32)
    hop_rank[order] = np.arange(n, dtype=np.int32)
    return hop_rank
