"""Distribution-Labeling (paper §5, Algorithm 2) — public entry point.

Process vertices in a total order (default rank: (dout+1)*(din+1) desc).
For each vertex v_i:

  * reverse pruned BFS: visiting u, if L_out(u) cap L_in(v_i) != empty the
    pair (u, v_i) is already covered through a higher-ranked hop -> do not
    label u and do not expand u; otherwise add v_i to L_out(u) and expand.
  * forward pruned BFS (symmetric): label L_in(w) with v_i unless
    L_in(w) cap L_out(v_i) != empty.

Theorem 3: complete.  Theorem 4: non-redundant (no hop can be removed).

Construction is owned by the ``repro_torch.build`` engine: ``impl="wave"``
runs the host wave-scheduled bit-parallel sweep, ``impl="speculative"`` the
host optimistic-chunk path for dense-reachability orders (sweep
rank-consecutive chunks without proving mutual unreachability, certify
prune-order violations exactly with word-level masks, correct violated
members from the chunk's append log), ``impl="device"`` the device wave
engine on ``device``, ``impl="reference"`` the scalar sets+deque path — all
produce labels byte-identical to each other and to every construction impl
of the JAX package.  ``impl="auto"`` (default) picks: reference below ~4k
vertices; speculative when a sampled reach-density probe (or a degenerate
exact schedule) flags the dense-reachability wall; otherwise the device
engine on the build's device.  It records its pick in
``build_stats["impl"]``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.oracle import ReachabilityOracle


def distribution_labeling(
    g,
    order: Optional[np.ndarray] = None,
    order_name: str = "degree_product",
    impl: str = "auto",
    device="cuda",
    **engine_kwargs,
) -> ReachabilityOracle:
    """Build the oracle for DAG ``g`` (int vertex ids 0..n-1); the device
    engine runs on ``device``.  ``engine_kwargs`` go to
    ``build_distribution_labels`` (``max_wave=``, ``checkpoint_dir=``, ...)."""
    # deferred: repro_torch.core's package init imports this module, while the
    # engine imports repro_torch.core.oracle — a top-level import would cycle
    from repro_torch.build.engine import build_distribution_labels

    return build_distribution_labels(
        g, order=order, order_name=order_name, impl=impl, device=device,
        **engine_kwargs
    )
