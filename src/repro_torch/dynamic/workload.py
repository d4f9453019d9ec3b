"""Interleaved update/query workload: trace generation + replay.

A trace is an alternating sequence of update batches and query batches —
the shape of live traffic against a mutating graph.  The generator keeps a
mirror of the live edge set so deletions always target existing edges and
insertions never duplicate; ``dag_preserving=True`` orients every insertion
by a fixed topological order of the initial graph, guaranteeing the
condensation never cycles (the pure label-repair fast path);
``dag_preserving=False`` samples arbitrary pairs and exercises SCC
merge/split maintenance too.

The replayer drives a ``DynamicOracle`` through the trace, publishing an
epoch per update batch and timing both sides of the interleave: update
apply+publish throughput and query latency under churn.

The counterpart of ``repro.dynamic.workload``, a copy: the same seed gives
the same trace and the same arrivals in both packages.  ``poisson_times``
is the open-loop arrival process ``serve.openloop`` drives the daemon with.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.dynamic.delta import UpdateBatch
from repro_torch.graph.csr import CSRGraph, topological_order


@dataclasses.dataclass(frozen=True)
class TraceOp:
    """One trace element: an update batch or a query batch."""
    kind: str  # "update" | "query"
    batch: Optional[UpdateBatch] = None
    queries: Optional[np.ndarray] = None


def poisson_times(rate_per_s: float, duration_s: float,
                  seed: int = 0) -> np.ndarray:
    """Open-loop arrival times: a Poisson process at ``rate_per_s`` over
    ``[0, duration_s)``, as a sorted float64 array of offsets in seconds
    (``repro.dynamic.workload.poisson_times``, draw for draw).

    Open-loop means arrivals are INDEPENDENT of service completions — the
    workload keeps coming whether or not the server keeps up, which is the
    regime that exposes overload behavior (closed-loop drivers self-throttle
    and hide it)."""
    rng = np.random.default_rng(seed)
    rate = max(float(rate_per_s), 1e-9)
    # draw in chunks: E[count] + 5 sigma covers the horizon w.h.p.
    est = int(rate * duration_s + 5 * np.sqrt(rate * duration_s) + 16)
    times = np.cumsum(rng.exponential(1.0 / rate, size=est))
    while times.size and times[-1] < duration_s:
        more = np.cumsum(rng.exponential(1.0 / rate, size=est)) + times[-1]
        times = np.concatenate([times, more])
    return times[times < duration_s]


def generate_trace(
    g: CSRGraph,
    rounds: int = 10,
    updates_per_round: int = 50,
    queries_per_round: int = 1000,
    insert_frac: float = 0.6,
    dag_preserving: bool = True,
    seed: int = 0,
) -> List[TraceOp]:
    """Alternating update/query trace over ``g`` (original vertex ids)."""
    rng = np.random.default_rng(seed)
    n = g.n
    # set for O(1) membership + parallel list (swap-pop) for O(1) sampling
    live = set()
    live_list: List[Tuple[int, int]] = []
    src, dst = g.edges()
    for a, b in zip(src.tolist(), dst.tolist()):
        if (a, b) not in live:
            live.add((a, b))
            live_list.append((a, b))
    if dag_preserving:
        topo = topological_order(g)
        pos = np.empty(n, dtype=np.int64)
        pos[topo] = np.arange(n)
    ops: List[TraceOp] = []
    for _ in range(rounds):
        inserts: List[Tuple[int, int]] = []
        deletes: List[Tuple[int, int]] = []
        for _ in range(updates_per_round):
            if rng.random() < insert_frac or not live:
                for _attempt in range(64):
                    a = int(rng.integers(0, n))
                    b = int(rng.integers(0, n))
                    if a == b:
                        continue
                    if dag_preserving:
                        if pos[a] == pos[b]:
                            continue
                        if pos[a] > pos[b]:
                            a, b = b, a
                    if (a, b) not in live:
                        live.add((a, b))
                        live_list.append((a, b))
                        inserts.append((a, b))
                        break
            else:
                k = int(rng.integers(0, len(live_list)))
                edge = live_list[k]
                live_list[k] = live_list[-1]
                live_list.pop()
                live.discard(edge)
                deletes.append(edge)
        ops.append(TraceOp("update", batch=UpdateBatch.of(inserts, deletes)))
        q = rng.integers(0, n, size=(queries_per_round, 2)).astype(np.int32)
        ops.append(TraceOp("query", queries=q))
    return ops


@dataclasses.dataclass
class ReplayStats:
    n_updates: int = 0
    n_queries: int = 0
    update_seconds: float = 0.0     # apply + publish
    query_seconds: float = 0.0
    query_latencies: List[float] = dataclasses.field(default_factory=list)
    repaired: int = 0
    rebuilds: int = 0
    structural: int = 0
    epochs: int = 0

    @property
    def updates_per_sec(self) -> float:
        return self.n_updates / self.update_seconds if self.update_seconds else 0.0

    def query_pctile(self, q: float) -> float:
        """Per-batch query latency percentile, seconds."""
        if not self.query_latencies:
            return 0.0
        return float(np.quantile(np.asarray(self.query_latencies), q))


def replay(dyn, trace: List[TraceOp], backend: Optional[str] = None,
           check_truth=None) -> ReplayStats:
    """Drive a DynamicOracle through a trace.

    ``check_truth(dyn, queries, answers)`` (optional) runs after every query
    batch — the hook the equivalence tests and the benchmark's
    rebuild-comparison use.
    """
    stats = ReplayStats()
    rebuilds0 = dyn.rebuild_count
    for op in trace:
        if op.kind == "update":
            t0 = time.perf_counter()
            st = dyn.apply(op.batch)
            dyn.publish()
            stats.update_seconds += time.perf_counter() - t0
            stats.n_updates += st.n_updates
            stats.repaired += st.repaired_inserts + st.repaired_deletes
            stats.structural += st.structural
            stats.epochs += 1
        else:
            t0 = time.perf_counter()
            ans = dyn.serve(op.queries, backend=backend)
            dt = time.perf_counter() - t0
            stats.query_seconds += dt
            stats.query_latencies.append(dt)
            stats.n_queries += op.queries.shape[0]
            if check_truth is not None:
                check_truth(dyn, op.queries, ans)
    stats.rebuilds = dyn.rebuild_count - rebuilds0
    return stats
