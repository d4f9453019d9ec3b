"""Distribution-Labeling (paper §5, Algorithm 2) — public entry point.

Process vertices in a total order (default rank: (dout+1)*(din+1) desc).
For each vertex v_i:

  * reverse pruned BFS: visiting u, if L_out(u) cap L_in(v_i) != empty the
    pair (u, v_i) is already covered through a higher-ranked hop -> do not
    label u and do not expand u; otherwise add v_i to L_out(u) and expand.
  * forward pruned BFS (symmetric): label L_in(w) with v_i unless
    L_in(w) cap L_out(v_i) != empty.

Theorem 3: complete.  Theorem 4: non-redundant (no hop can be removed).

Construction is owned by the ``repro_torch.build`` engine.  This slice of
the port carries the scalar reference path (``impl="reference"``);
``impl="auto"`` resolves to it and records that in ``build_stats["impl"]``.
Its labels are byte-identical to every construction impl of the JAX
package.  The wave, speculative and device engines are later slices.
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
    **engine_kwargs,
) -> ReachabilityOracle:
    """Build the oracle for DAG ``g`` (int vertex ids 0..n-1)."""
    # deferred: repro_torch.core's package init imports this module, while the
    # engine imports repro_torch.core.oracle — a top-level import would cycle
    from repro_torch.build.engine import build_distribution_labels

    return build_distribution_labels(
        g, order=order, order_name=order_name, impl=impl, **engine_kwargs
    )
