"""The port's dynamic oracle (the counterpart of ``repro.dynamic``):
incremental label maintenance under edge updates.

    dyn = DynamicOracle(g)                  # on the card; device="cpu" too
    dyn.apply(UpdateBatch.of(inserts=[(u, v)], deletes=[(a, b)]))
    e = dyn.publish()                       # new immutable epoch
    dyn.serve(queries)                      # current epoch, full engine path
    dyn.serve(queries, epoch=e - 1)         # pinned older snapshot

Layers: ``delta`` (edge log + SCC-condensation maintenance), ``repair``
(resumed pruned-BFS label repair), ``versioned`` (epoch snapshots, COW
publish, staleness budget), ``durable`` (WAL + snapshot crash recovery),
``workload`` (interleaved trace generation and replay, and the daemon's
open-loop arrivals).  Pinned older epochs serve through K1's tier form
(``kernels/csrc/label_intersect.cu``), the current one through the engine.
"""
from repro_torch.dynamic.delta import (
    CondensationState,
    DeltaEvent,
    EdgeUpdate,
    UpdateBatch,
)
from repro_torch.dynamic.durable import DurableDynamicOracle
from repro_torch.dynamic.repair import MutableLabels, repair_delete, repair_insert
from repro_torch.dynamic.versioned import ApplyStats, DynamicOracle, LabelEpoch
from repro_torch.dynamic.workload import ReplayStats, TraceOp, generate_trace, replay

__all__ = [
    "ApplyStats",
    "CondensationState",
    "DeltaEvent",
    "DurableDynamicOracle",
    "DynamicOracle",
    "EdgeUpdate",
    "LabelEpoch",
    "MutableLabels",
    "ReplayStats",
    "TraceOp",
    "UpdateBatch",
    "generate_trace",
    "repair_delete",
    "repair_insert",
    "replay",
]
