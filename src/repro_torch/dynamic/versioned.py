"""Versioned serving over a mutating oracle: epochs, COW publish, budgets.

The serving contract under churn:

  * every published **epoch** is an immutable ``LabelEpoch`` snapshot —
    labels, condensation comp array, and topological levels frozen together
    so a query pinned to epoch e sees one consistent world,
  * updates mutate a WORKING copy (``repair.MutableLabels`` + the live
    ``delta.CondensationState``); nothing a query can observe changes until
    ``publish()``,
  * publish copy-on-writes only the dirty rows into the previous snapshot's
    dense layout (``ReachabilityOracle.with_updated_rows``) and refreshes
    the QueryEngine in place — device label arrays and the bucketed-batching
    tier plan are re-derived exactly once per epoch (the refresh uploads the
    labels and drops the engine's ``ServeBatch``, rebuilt on the next kernel
    batch),
  * a **staleness budget** decides repair-vs-rebuild: structural SCC events
    (merge/split), oversized delete cones, or cumulative churn beyond a
    fraction of the index all route the next publish through ``repro_torch.build``
    for a compacting full rebuild (fresh §5.2 order, fresh ranks, fresh
    levels).

Query routing: the current epoch serves through the QueryEngine (all
backends, prefilters, bucketing; on the card the ``kernel`` backend, K1's
batch form ``csrc/serve_batch.cu``); older pinned epochs serve through their
snapshot's retained device arrays (prefilters + one batched device
intersect, K1's tier form ``csrc/label_intersect.cu`` — see
``LabelEpoch``), with the scalar host merge kept only as a
differential-test path.

Observability: every publish appends to ``growth_log`` — label-int count,
appends/drops of the epoch window, and the per-epoch growth rate.  Rank
drift under churn (repairs distribute hops at stale build-time ranks) shows
up as a persistently positive growth rate long before the staleness budget
fires.

The counterpart of ``repro.dynamic.versioned``: ``apply``, ``publish``, the
staleness budget, ``growth_log``, the epoch window and the metric families
are ``repro``'s.  The port adds ``device`` (default ``"cuda"``; the engine,
the builds and the pinned epochs run there, and ``"cpu"`` runs the plain
versions of the kernels); ``mesh`` goes to the engine, whose sharded
backends serve the current epoch over it (pinned epochs serve on this
rank's device).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch

from repro_torch.build.engine import build_distribution_labels
from repro_torch.core.oracle import ReachabilityOracle
from repro_torch.device import resolve_device
from repro_torch.ft import inject
from repro_torch.dynamic import delta as delta_mod
from repro_torch.dynamic.delta import CondensationState, UpdateBatch
from repro_torch.dynamic.repair import MutableLabels, repair_delete, repair_insert
from repro_torch.graph.csr import CSRGraph
from repro_torch.obs import metrics, trace
from repro_torch.obs.state import ON
from repro_torch.serve.engine import QueryEngine, serve_step
from repro_torch.serve.prefilter import apply_prefilters, topo_levels

# growth_log stays the per-epoch history view; the registry carries the
# live aggregates the unified snapshot surface reports
_M_PUBLISHES = metrics.counter(
    "dynamic_publishes_total", "published epochs, by kind",
    labelnames=("kind",))
_PUB_REPAIRED = _M_PUBLISHES.labels(kind="repaired")
_PUB_REBUILT = _M_PUBLISHES.labels(kind="rebuilt")
_M_LABEL_INTS = metrics.gauge(
    "dynamic_label_ints", "label ints in the latest published epoch")
_M_GROWTH_RATE = metrics.gauge(
    "dynamic_growth_rate", "label-int growth rate of the latest publish")


@dataclasses.dataclass(frozen=True)
class LabelEpoch:
    """One immutable published snapshot.

    The snapshot's device label arrays stay ALIVE for as long as the epoch
    is pinnable (``ReachabilityOracle.device_labels`` memoizes the upload on
    the immutable oracle), so pinned-epoch batches run the same prefilter +
    device-intersect path as the current epoch instead of falling back to a
    per-query host merge — pinning costs one upload per epoch, not one per
    pin.

    ``device`` is the torch device the epoch serves on (its owner's).  On
    the card the device intersect is K1's tier form, one launch of
    ``csrc/label_intersect.cu`` a batch on that device's current stream; on
    the CPU it is the kernel's plain version, ``ref.tier_intersect_ref``."""
    epoch: int
    oracle: ReachabilityOracle
    comp: np.ndarray     # original vertex -> condensation id, frozen copy
    level: np.ndarray    # topological levels of the condensation, frozen
    device: torch.device = "cuda"

    def query_batch(self, queries: np.ndarray, device: bool = True) -> np.ndarray:
        """Batch answers in ORIGINAL vertex ids (pinned epoch).

        ``device=False`` forces the old per-query host merge (kept for
        differential tests and the daemon's injected-failure rung)."""
        cq = self.comp[np.asarray(queries, dtype=np.int64)].astype(np.int32)
        o = self.oracle
        pf = apply_prefilters(cq, o.out_len, o.in_len, self.level)
        out = pf.decided & pf.value
        rest = np.nonzero(~pf.decided)[0]
        if rest.size == 0:
            return out
        if device:
            lo, li = o.device_labels(self.device)  # memoized: no per-pin re-upload
            q = torch.from_numpy(np.ascontiguousarray(cq[rest])).to(lo.device)
            out[rest] = serve_step(lo, li, q, use_kernel=True).cpu().numpy()
            return out
        for i in rest:
            out[i] = o.query(int(cq[i, 0]), int(cq[i, 1]))
        return out


@dataclasses.dataclass
class ApplyStats:
    """What one ``apply`` batch did."""
    n_updates: int = 0
    noop: int = 0
    repaired_inserts: int = 0
    repaired_deletes: int = 0
    structural: int = 0
    deferred: int = 0          # events skipped because a rebuild is pending
    label_appends: int = 0
    label_drops: int = 0
    rebuild_pending: bool = False


class DynamicOracle:
    """Reachability oracle over a LIVE digraph: edge updates between epochs.

    Parameters
    ----------
    g : CSRGraph
        Initial digraph (cycles allowed — SCCs are condensed and maintained
        incrementally from then on).
    backend, mesh, bucketing : forwarded to the QueryEngine.
    staleness_budget : float
        Fraction of the index (in label ints) the incremental repairs may
        churn before the next publish compacts via a full rebuild.
    max_cone_frac : float
        A delete whose affected cone (|anc(u)| + |desc(v)|) exceeds this
        fraction of live condensation vertices falls back to rebuild — past
        that point the scoped re-distribution costs more than building.
    keep_epochs : int
        How many published snapshots stay pinnable.
    build_impl : str
        ``build_distribution_labels``' impl for every compacting rebuild.
    device : str or torch.device
        Where the engine, the device builds and the pinned epochs run;
        ``"cuda"`` by default (``RuntimeError`` without a card), ``"cpu"``
        runs the kernels' plain versions.
    """

    def __init__(
        self,
        g: CSRGraph,
        backend: str = "auto",
        mesh=None,
        bucketing: bool = True,
        staleness_budget: float = 0.5,
        max_cone_frac: float = 0.1,
        keep_epochs: int = 4,
        build_impl: str = "auto",
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.delta = CondensationState(g)
        self.staleness_budget = float(staleness_budget)
        self.max_cone_frac = float(max_cone_frac)
        self.keep_epochs = int(keep_epochs)
        self.build_impl = build_impl
        self._rebuild_pending = False
        self._churn = 0
        self.rebuild_count = 0
        self.repair_count = 0
        # per-publish label-ints trajectory (rank-drift observability)
        self.growth_log: List[dict] = []
        self._last_ints = 0
        self._rebuild_labels()
        self._last_ints = self.labels.label_ints()
        self._epochs: "OrderedDict[int, LabelEpoch]" = OrderedDict()
        self._epoch = 0
        self.engine = QueryEngine(
            self._snapshot_oracle(), backend=backend, mesh=mesh,
            bucketing=bucketing, level=self.level,
            comp_source=self._current_comp, epoch=0,
            # frozen materialization of the initial condensation DAG: the
            # degradation ladder's search rung must answer against the
            # SERVED epoch's graph, never the live mutating delta
            fallback_graph=self.delta.dag_csr(), device=self.device,
        )
        self._install_epoch(self._snapshot_oracle())

    # ----------------------------------------------------------- internals

    def _current_comp(self) -> np.ndarray:
        """Comp array of the CURRENT epoch (what the engine serves)."""
        return self._epochs[self._epoch].comp if self._epochs else self.delta.comp

    def _rebuild_labels(self) -> None:
        """Compacting rebuild: fresh order/ranks/levels from repro_torch.build."""
        dag = self.delta.dag_csr()
        oracle = build_distribution_labels(dag, impl=self.build_impl, device=self.device)
        self.hop_rank = oracle.hop_rank
        self.inv_rank = np.argsort(self.hop_rank).astype(np.int32)
        self.labels = MutableLabels.from_oracle(oracle)
        self.level = topo_levels(dag)
        self._base_oracle = oracle  # COW base for the next publish
        self._rebuild_pending = False
        self._churn = 0
        self.rebuild_count += 1

    def _snapshot_oracle(self) -> ReachabilityOracle:
        """Finalize the working rows into an immutable oracle via COW."""
        out_rows, in_rows = self.labels.take_dirty()
        if out_rows or in_rows:
            self._base_oracle = self._base_oracle.with_updated_rows(out_rows, in_rows)
        return self._base_oracle

    def _install_epoch(self, oracle: ReachabilityOracle) -> None:
        ep = LabelEpoch(
            epoch=self._epoch,
            oracle=oracle,
            comp=self.delta.comp.copy(),
            level=np.asarray(self.level, dtype=np.int32).copy(),
            device=self.device,
        )
        self._epochs[self._epoch] = ep
        while len(self._epochs) > self.keep_epochs:
            self._epochs.popitem(last=False)

    def _raise_levels(self, cu: int, cv: int) -> None:
        """Scoped topological-level maintenance after DAG insert (cu, cv).

        Levels must stay a valid topological numbering for the serve-path
        level prefilter to remain sound; deletions only relax constraints
        (the old numbering stays valid), insertions propagate forward."""
        if self.level[cu] < self.level[cv]:
            return
        level = self.level
        level[cv] = level[cu] + 1
        stack = [cv]
        while stack:
            x = stack.pop()
            lx = level[x] + 1
            for w in self.delta.dag_out[x]:
                if level[w] < lx:
                    level[w] = lx
                    stack.append(w)

    # -------------------------------------------------------------- update

    def apply(self, batch: UpdateBatch) -> ApplyStats:
        """Apply an update batch to the WORKING state (visible at publish).

        Each update flows: condensation maintenance (``delta``) -> label
        repair for plain DAG events -> structural events or budget misses
        mark the epoch for a compacting rebuild at the next publish.
        """
        stats = ApplyStats(n_updates=len(batch))
        max_cone = max(64, int(self.max_cone_frac * max(self.delta.n_live, 1)))
        for up in batch.updates:
            ev = (self.delta.insert(up.u, up.v) if up.insert
                  else self.delta.delete(up.u, up.v))
            if ev.kind == delta_mod.NOOP:
                stats.noop += 1
                continue
            if ev.structural:
                stats.structural += 1
                self._rebuild_pending = True
                continue
            if self._rebuild_pending:
                stats.deferred += 1
                continue  # labels are already stale; the rebuild covers it
            if ev.kind == delta_mod.DAG_INSERT:
                before = self.labels.appends
                repair_insert(self.labels, self.delta, self.inv_rank,
                              ev.cu, ev.cv)
                self._raise_levels(ev.cu, ev.cv)
                stats.repaired_inserts += 1
                stats.label_appends += self.labels.appends - before
                self.repair_count += 1
            else:  # DAG_DELETE
                before_a, before_d = self.labels.appends, self.labels.drops
                ok = repair_delete(self.labels, self.delta, self.hop_rank,
                                   self.inv_rank, ev.cu, ev.cv, max_cone)
                if not ok:
                    self._rebuild_pending = True
                    continue
                stats.repaired_deletes += 1
                stats.label_appends += self.labels.appends - before_a
                stats.label_drops += self.labels.drops - before_d
                self.repair_count += 1
        self._churn += stats.label_appends + stats.label_drops
        total = max(self.labels.label_ints(), 1)
        if self._churn > self.staleness_budget * total:
            self._rebuild_pending = True
        stats.rebuild_pending = self._rebuild_pending
        return stats

    def publish(self) -> int:
        """Publish the working state as a new immutable epoch.

        TRANSACTIONAL: every expensive step (compacting rebuild, COW row
        merge, frozen-DAG materialization) is staged into locals first; live
        state — epoch counter, pinned snapshots, the serving engine, the
        dirty-row sets — mutates only at the commit point below.  A failure
        mid-publish (crash, injected fault, rebuild OOM) leaves the previous
        epoch serving and the working state intact, so the publish can
        simply be retried."""
        rebuilt = self._rebuild_pending
        sp = (trace.span("publish.stage", cat="dynamic",
                         args={"epoch": self._epoch + 1, "rebuilt": rebuilt})
              if ON.enabled else trace.NOOP_SPAN)
        # ---- stage ----------------------------------------------------
        with sp:
            staged_rebuild = None
            if rebuilt:
                dag = self.delta.dag_csr()
                base = build_distribution_labels(dag, impl=self.build_impl,
                                                 device=self.device)
                staged_rebuild = {
                    "hop_rank": base.hop_rank,
                    "inv_rank": np.argsort(base.hop_rank).astype(np.int32),
                    "labels": MutableLabels.from_oracle(base),
                    "level": topo_levels(dag),
                }
                oracle = base
            else:
                out_rows, in_rows = self.labels.peek_dirty()
                oracle = (self._base_oracle.with_updated_rows(out_rows, in_rows)
                          if (out_rows or in_rows) else self._base_oracle)
            fallback = self.delta.dag_csr()  # frozen graph of THIS epoch
            # chaos hook: a crash here must leave the old epoch serving and
            # the epoch counter unchanged (regression: dynamic.publish
            # injection)
            inject.fire("dynamic.publish", epoch=self._epoch + 1,
                        rebuilt=rebuilt)
        sp = (trace.span("publish.commit", cat="dynamic",
                         args={"epoch": self._epoch + 1, "rebuilt": rebuilt})
              if ON.enabled else trace.NOOP_SPAN)
        # ---- commit ---------------------------------------------------
        with sp:
            # read the epoch window's churn BEFORE a rebuild swaps in a fresh
            # MutableLabels (whose counters start at zero) — rebuild epochs
            # are exactly the churn-heaviest ones
            appends, drops = self.labels.epoch_counters()
            if rebuilt:
                self.hop_rank = staged_rebuild["hop_rank"]
                self.inv_rank = staged_rebuild["inv_rank"]
                self.labels = staged_rebuild["labels"]
                self.level = staged_rebuild["level"]
                self._rebuild_pending = False
                self._churn = 0
                self.rebuild_count += 1
            else:
                self.labels.clear_dirty()
            self._base_oracle = oracle
            self._epoch += 1
            self._install_epoch(oracle)
            self.engine.refresh(oracle, level=self.level, epoch=self._epoch,
                                fallback_graph=fallback)
        # growth-rate tracking: a persistently positive rate under churn is
        # rank drift (repairs distribute at stale build-time ranks) and
        # argues for re-ranking before the staleness budget fires
        ints = self.labels.label_ints()
        prev = max(self._last_ints, 1)
        rate = round((ints - self._last_ints) / prev, 6)
        self.growth_log.append({
            "epoch": self._epoch,
            "label_ints": ints,
            "appends": appends,
            "drops": drops,
            "rebuilt": rebuilt,
            "growth_rate": rate,
        })
        (_PUB_REBUILT if rebuilt else _PUB_REPAIRED).inc()
        _M_LABEL_INTS.set(ints)
        _M_GROWTH_RATE.set(rate)
        self._last_ints = ints
        return self._epoch

    # -------------------------------------------------------------- serve

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def epochs(self) -> List[int]:
        return list(self._epochs.keys())

    @property
    def total_label_size(self) -> int:
        return self._epochs[self._epoch].oracle.total_label_size

    def snapshot(self, epoch: Optional[int] = None) -> LabelEpoch:
        ep = self._epoch if epoch is None else int(epoch)
        if ep not in self._epochs:
            raise KeyError(
                f"epoch {ep} not pinnable (kept: {list(self._epochs)})")
        return self._epochs[ep]

    def query(self, u: int, v: int, epoch: Optional[int] = None) -> bool:
        """Single query in ORIGINAL vertex ids, optionally pinned."""
        if epoch is None or epoch == self._epoch:
            return self.engine.query(int(u), int(v))
        ep = self.snapshot(epoch)
        return bool(ep.query_batch(np.array([[u, v]], dtype=np.int64))[0])

    def serve(self, queries: np.ndarray, backend: Optional[str] = None,
              epoch: Optional[int] = None,
              deadline: Optional[float] = None) -> np.ndarray:
        """Batched queries in ORIGINAL vertex ids.

        ``epoch=None`` (or the current epoch) runs the full QueryEngine
        path; an older pinned epoch answers from its frozen snapshot.
        ``deadline`` is the daemon's absolute latency budget (see
        ``QueryEngine.query_batch``; pinned-epoch snapshots ignore it, as
        ``repro``'s do)."""
        if epoch is None or epoch == self._epoch:
            return self.engine.query_batch(np.asarray(queries), backend=backend,
                                           deadline=deadline)
        return self.snapshot(epoch).query_batch(np.asarray(queries))
