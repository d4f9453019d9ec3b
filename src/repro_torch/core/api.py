"""Top-level oracle API of the port: arbitrary digraphs (cycles allowed) in
one call, served on the card.

    oracle = build_oracle(graph)            # device="cuda" by default
    oracle.query(u, v)                      # original vertex ids
    oracle.serve(queries)                   # batched engine path
    oracle.serve(queries, backend="dense")  # pick the intersection backend

The counterpart of ``repro.core.api``: SCC condensation, Distribution-
Labeling on the condensation, and a ``repro_torch.serve.QueryEngine``
(prefilters + length bucketing + pluggable backends) whose label matrices
live on ``device``.  Cold start from a snapshot (``oracle_from_snapshot``)
comes with the persist slice (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np

from repro_torch.core.distribution import distribution_labeling
from repro_torch.core.oracle import ReachabilityOracle
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.scc import condense_to_dag
from repro_torch.serve.engine import QueryEngine
from repro_torch.serve.prefilter import topo_levels


@dataclasses.dataclass(frozen=True)
class CondensedOracle:
    """Reachability oracle over the SCC condensation of a digraph.

    Queries take ORIGINAL vertex ids; two vertices in the same SCC reach
    each other by definition (the engine's same-id prefilter answers them).
    """

    oracle: ReachabilityOracle
    comp: np.ndarray  # int32[n_original] -> condensation vertex id
    engine: QueryEngine

    @property
    def total_label_size(self) -> int:
        return self.oracle.total_label_size

    def query(self, u: int, v: int) -> bool:
        return self.engine.query(int(u), int(v))

    def serve(self, queries: np.ndarray, backend: Optional[str] = None,
              deadline: Optional[float] = None) -> np.ndarray:
        """Batched engine path. queries: int[B, 2] original ids -> bool[B]."""
        return self.engine.query_batch(np.asarray(queries), backend=backend,
                                       deadline=deadline)


def build_oracle(
    g: CSRGraph,
    method: Literal["distribution", "hierarchical"] = "distribution",
    backend: str = "auto",
    bucketing: bool = True,
    device="cuda",
    **kwargs,
) -> CondensedOracle:
    """Condense SCCs, label with DL, wire up the serve engine on ``device``.

    Raises ``RuntimeError`` before any work when ``device`` is CUDA and
    torch sees no CUDA device."""
    device = resolve_device(device)
    if method == "hierarchical":
        raise NotImplementedError(
            "Hierarchical-Labeling is not ported yet: ROADMAP.md Queue 1 item 5")
    if method != "distribution":
        raise ValueError(method)
    dag, comp = condense_to_dag(g)
    oracle = distribution_labeling(dag, **kwargs)
    engine = QueryEngine(
        oracle,
        backend=backend,
        level=topo_levels(dag),
        bucketing=bucketing,
        # degradation ladder bottom rung: the condensation DAG the labels
        # index, so corrupted/missing rows degrade to exact online search
        fallback_graph=dag,
        device=device,
    )
    co = CondensedOracle(oracle=oracle, comp=comp, engine=engine)
    # queries reach the engine in original ids; the engine reads the comp
    # array through the oracle at call time (never a private cached copy)
    engine.comp_source = lambda: co.comp
    return co
