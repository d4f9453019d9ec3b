"""Top-level oracle API of the port: arbitrary digraphs (cycles allowed) in
one call, served on the card.

    oracle = build_oracle(graph)            # device="cuda" by default
    oracle.query(u, v)                      # original vertex ids
    oracle.serve(queries)                   # batched engine path
    oracle.serve(queries, backend="dense")  # pick the intersection backend
    oracle = oracle_from_snapshot(graph, path)  # cold start, no rebuild

The counterpart of ``repro.core.api``: SCC condensation, Distribution-
Labeling (default) or Hierarchical-Labeling on the condensation (or a
``persist`` snapshot of its labels), and
a ``repro_torch.serve.QueryEngine`` (prefilters + length bucketing +
pluggable backends) whose label matrices live on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np

from repro_torch.core.distribution import distribution_labeling
from repro_torch.core.hierarchy import hierarchical_labeling
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
    mesh=None,
    bucketing: bool = True,
    device="cuda",
    **kwargs,
) -> CondensedOracle:
    """Condense SCCs, label with DL (default) or HL, wire up the serve
    engine on ``device``.

    The DL build runs on ``device`` too when it uses the device engine
    (``impl="device"``, or ``impl="auto"`` on a large sparse graph); HL's
    levels build on the host and its core through DL.  ``mesh`` (a
    ``DeviceMesh`` from ``repro_torch.launch.mesh``) goes to the engine for
    the sharded backends, as in the JAX package; every rank of it calls
    this with the same graph.

    Raises ``RuntimeError`` before any work when ``device`` is CUDA and
    torch sees no CUDA device."""
    device = resolve_device(device)
    if method == "distribution":
        label = distribution_labeling
    elif method == "hierarchical":
        label = hierarchical_labeling
    else:
        raise ValueError(method)
    dag, comp = condense_to_dag(g)
    oracle = label(dag, device=device, **kwargs)
    engine = QueryEngine(
        oracle,
        backend=backend,
        level=topo_levels(dag),
        mesh=mesh,
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


def oracle_from_snapshot(
    g: CSRGraph,
    path: str,
    mode: Literal["strict", "quarantine"] = "strict",
    backend: str = "auto",
    mesh=None,
    bucketing: bool = True,
    device="cuda",
) -> CondensedOracle:
    """Cold-start serving: wire a persisted label snapshot to ``g``'s
    condensation instead of rebuilding the index, with the engine on
    ``device``.

    ``mode="strict"`` raises ``persist.CorruptSnapshotError`` on any
    checksum mismatch; ``mode="quarantine"`` loads anyway, zeroes the
    corrupt row blocks, and arms the engine's quarantine masks so queries
    touching them degrade to exact online search over the condensation DAG.

    The caller vouches that ``path`` was saved from THIS graph's
    condensation (``save_oracle(path, co.oracle)``, by either package); a
    snapshot of a different graph fails the cheap shape check here and
    answers garbage past it.  ``mesh`` goes to the engine, as in
    ``build_oracle``.  Raises ``RuntimeError`` before any work when
    ``device`` is CUDA and torch sees no CUDA device."""
    from repro_torch.persist import load_oracle

    device = resolve_device(device)
    if mode not in ("strict", "quarantine"):
        raise ValueError(f"mode must be strict|quarantine, got {mode!r}")
    dag, comp = condense_to_dag(g)
    report = None
    if mode == "strict":
        oracle = load_oracle(path, strict=True)
    else:
        oracle, report = load_oracle(path, strict=False)
    if oracle.n != dag.n:
        raise ValueError(
            f"snapshot at {path} indexes {oracle.n} vertices but the "
            f"graph's condensation has {dag.n} — wrong snapshot for this graph")
    engine = QueryEngine(
        oracle, backend=backend, level=topo_levels(dag), mesh=mesh,
        bucketing=bucketing, fallback_graph=dag, device=device,
    )
    co = CondensedOracle(oracle=oracle, comp=comp, engine=engine)
    engine.comp_source = lambda: co.comp
    if report is not None and not report.clean:
        engine.set_quarantine(report.quarantine_out, report.quarantine_in)
    return co
