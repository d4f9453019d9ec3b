"""QueryEngine: the port's serve subsystem, pluggable intersection backends.

The counterpart of ``repro.serve.engine``.  The engine owns the serving
pipeline:

    queries -> prefilters (repro_torch.serve.prefilter)
            -> length-bucketed micro-batches (repro_torch.serve.planner)
            -> backend intersection on the engine's device
            -> scatter back

Backends:
  host    per-query sorted merge on the CPU (searchsorted + rank-ordered
          early exit; the reference path)
  dense   all-pairs compare in torch ops on the engine's device
  kernel  the hand-written CUDA kernel ``kernels.ops.tier_intersect`` (on a
          CPU engine the wrapper runs the kernel's plain version)

``backend="auto"`` picks ``kernel`` when the engine's device is CUDA and
``dense`` on the CPU.  The multi-device ``sharded`` / ``sharded_hop``
backends are not ported yet (ROADMAP.md Queue 1 item 11).

Verdicts, prefilter counts, tier stats and degradation counters equal the
JAX engine's on the same labels and queries.
"""
from __future__ import annotations

import copy
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.ft import inject
from repro_torch.graph.csr import INVALID
from repro_torch.kernels import ops, ref
from repro_torch.obs import metrics, trace
from repro_torch.obs.state import ON
from repro_torch.serve.planner import plan_batch, tier_widths
from repro_torch.serve.prefilter import apply_prefilters

BACKENDS = ("host", "dense", "kernel")
_NOT_PORTED = {
    "sharded": "ROADMAP.md Queue 1 item 11 (multi-device modes)",
    "sharded_hop": "ROADMAP.md Queue 1 item 11 (multi-device modes)",
}


def select_backend(name: Optional[str] = None, device="cuda") -> str:
    """Resolve a backend name ('auto'/None = kernel on CUDA, dense on CPU)."""
    if name in (None, "auto"):
        return "kernel" if torch.device(device).type == "cuda" else "dense"
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {name!r} is not ported yet: {_NOT_PORTED[name]}")
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected one of {BACKENDS}")
    return name


# ---------------------------------------------------------------- primitives


# the dense primitive under the JAX package's name; one definition, in ref
intersect_rows = ref.label_intersect_ref


def _tier_intersect(L_out: torch.Tensor, L_in: torch.Tensor,
                    queries: torch.Tensor, width: int,
                    use_kernel: bool) -> torch.Tensor:
    """Gather + truncate to the tier width + intersect.  The kernel fuses
    all three; the dense path is the kernel's plain version in torch ops."""
    if use_kernel:
        return ops.tier_intersect(L_out, L_in, queries, width)
    return ref.tier_intersect_ref(L_out, L_in, queries, width)


def serve_step(L_out: torch.Tensor, L_in: torch.Tensor, queries: torch.Tensor,
               use_kernel: bool = False) -> torch.Tensor:
    """One-shot batched intersection at full label width (the engine adds
    prefilters + bucketing on top).

    L_out: int32[n, Lo], L_in: int32[n, Li], queries: int32[B, 2].
    """
    width = max(L_out.shape[1], L_in.shape[1])
    return _tier_intersect(L_out, L_in, queries, width, use_kernel)


# ----------------------------------------------------------------- engine

# every downgrade the ladder can count; stats()/reset_stats() and the
# per-batch tallies all start from this shape so no consumer ever sees a
# partially populated counter dict (the same keys as the JAX engine's)
_ZERO_DEGRADATION = {
    "device_to_host": 0,   # device backend failed -> host merge
    "deadline_to_host": 0, # batch past deadline -> skip device
    "searched": 0,         # labels unusable -> exact bidirectional search
    "quarantined": 0,      # queries that touched quarantined label rows
    "uncertain": 0,        # budget-truncated miss (budget tier not ported yet)
}

_M_QUERIES = metrics.counter(
    "engine_queries_total", "queries through QueryEngine.query_batch")
_M_PREFILTERED = metrics.counter(
    "engine_prefiltered_total", "queries decided by the prefilter stack")
_M_DEGRADED = metrics.counter(
    "engine_degraded_total", "ladder downgrades, by kind", labelnames=("kind",))
_DEGRADED_KIND = {k: _M_DEGRADED.labels(kind=k) for k in _ZERO_DEGRADATION}
_M_EPOCH = metrics.gauge(
    "engine_epoch", "label-snapshot epoch the engine currently serves")


class QueryEngine:
    """The serve subsystem for one ReachabilityOracle.

    Parameters
    ----------
    oracle : ReachabilityOracle
        Labels in the engine's id space (condensation ids when built through
        ``repro_torch.core.api``).
    backend : str
        One of BACKENDS or "auto".
    level : optional int32[n]
        Topological levels for the level prefilter (``prefilter.topo_levels``).
    bucketing : bool
        Length-bucketed micro-batching for dense/kernel backends.
    comp_source : optional callable -> int32[n_original]
        When set, queries arrive in ORIGINAL vertex ids and are mapped to the
        oracle's condensation id space through ``comp_source()`` at call time.
    epoch : int
        Label-snapshot epoch this engine serves.
    fallback_graph : optional CSRGraph or callable -> CSRGraph
        The DAG the labels index, in the ORACLE'S id space — the bottom rung
        of the degradation ladder (exact bidirectional online search when
        labels cannot be trusted).
    device : str or torch.device
        Where the label matrices live and the dense/kernel backends run.
        Defaults to ``"cuda"``; raises ``RuntimeError`` when torch sees no
        CUDA device, unless ``device="cpu"`` is given.

    Degradation ladder
    ------------------
    A device failure injected at ``serve.device_dispatch`` (``ft.inject``)
    downgrades the whole sub-batch to the host merge path (same labels,
    same verdicts, counted as ``device_to_host``, as the JAX engine counts
    it).  A real failure of the device path (the kernel does not build, a
    launch or a CUDA call fails) is raised, never served on the CPU: the
    JAX engine's catch-all would hide a broken kernel behind correct
    verdicts.
    a query touching a *quarantined* label row (``set_quarantine``) skips
    labels entirely and runs the exact online search.  Every rung returns
    correct verdicts; ``self.degradation`` counts how often each downgrade
    fired.  The memory-budget tier (``set_budget``) is not ported yet.
    """

    def __init__(
        self,
        oracle,
        backend: str = "auto",
        level: Optional[np.ndarray] = None,
        bucketing: bool = True,
        n_tiers: int = 3,
        min_tile: int = 256,
        comp_source=None,
        epoch: int = 0,
        fallback_graph=None,
        search_node_budget: Optional[int] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.oracle = oracle
        self.backend = select_backend(backend, self.device)
        # own copy: the owner may keep mutating its working level array
        self.level = None if level is None else np.array(level, dtype=np.int32)
        self.bucketing = bucketing
        self.min_tile = int(min_tile)
        self.n_tiers = int(n_tiers)
        self.comp_source = comp_source
        self.epoch = int(epoch)
        self._lo, self._li = oracle.device_labels(self.device)
        self.widths = tier_widths(
            oracle.out_len, oracle.in_len, oracle.max_label_len, n_tiers=n_tiers
        )
        self.last_stats: dict = {}
        self._fallback_graph = fallback_graph
        self._fallback_csr = None   # resolved (graph, reverse) pair, lazy
        self.quarantine_out: Optional[np.ndarray] = None
        self.quarantine_in: Optional[np.ndarray] = None
        # cumulative downgrade counters; mutated only under _stats_lock so
        # stats()/reset_stats() are atomic with respect to in-flight tallies
        self.degradation = dict(_ZERO_DEGRADATION)
        self._stats_lock = threading.Lock()
        self.search_node_budget = search_node_budget

    # ------------------------------------------------------- observability

    def stats(self) -> dict:
        """Consistent snapshot of the engine's serving state, key for key
        the JAX engine's (``budget`` stays None until the budget tier is
        ported)."""
        with self._stats_lock:
            return {
                "epoch": self.epoch,
                "backend": self.backend,
                "widths": list(self.widths),
                "n_quarantined": int(
                    (0 if self.quarantine_out is None else int(self.quarantine_out.sum()))
                    + (0 if self.quarantine_in is None else int(self.quarantine_in.sum()))),
                "budget": None,
                "degradation": dict(self.degradation),
                "last_batch": copy.deepcopy(self.last_stats),
            }

    def reset_stats(self) -> None:
        """Zero the cumulative degradation counters and the last-batch
        record; the counter dict is swapped whole under the lock."""
        with self._stats_lock:
            self.degradation = dict(_ZERO_DEGRADATION)
            self.last_stats = {}

    # ------------------------------------------------- degradation ladder

    def set_quarantine(self, quarantine_out: Optional[np.ndarray],
                       quarantine_in: Optional[np.ndarray]) -> None:
        """Mark label rows that must not be trusted.  Queries touching them
        route to the online-search rung instead of reading the rows."""
        def _norm(q):
            if q is None or not np.any(q):
                return None
            return np.asarray(q, dtype=bool)

        self.quarantine_out = _norm(quarantine_out)
        self.quarantine_in = _norm(quarantine_in)

    @property
    def budget_store(self):
        """The active budget store: always None until the tier is ported."""
        return None

    def set_budget(self, store) -> None:
        """Removing a budget (``None``) is a no-op; installing one needs the
        budget tier (ROADMAP.md Queue 1 item 7), not ported yet."""
        if store is not None:
            raise NotImplementedError(
                "memory-budgeted serving is not ported yet: ROADMAP.md "
                "Queue 1 item 7 (serve/budget.py)")

    def _fallback(self):
        """Resolve the fallback graph to a cached (g, g_rev) pair."""
        if self._fallback_csr is None:
            g = self._fallback_graph
            if g is None:
                raise RuntimeError(
                    "degradation ladder exhausted: quarantined label rows "
                    "need the online-search rung, but no fallback_graph was "
                    "configured on this QueryEngine")
            if callable(g):
                g = g()
            self._fallback_csr = (g, g.reverse())
        return self._fallback_csr

    def _search_batch(self, rest: np.ndarray) -> np.ndarray:
        """Bottom rung: exact bidirectional search, no label reads."""
        from repro_torch.core.baselines.online_search import bidirectional_query

        g, g_rev = self._fallback()
        out = np.empty(rest.shape[0], dtype=bool)
        for i, (u, v) in enumerate(rest):
            out[i] = bidirectional_query(g, g_rev, int(u), int(v),
                                         node_budget=self.search_node_budget)
        return out

    # ------------------------------------------------------------- queries

    def _map_ids(self, queries: np.ndarray) -> np.ndarray:
        comp = self.comp_source() if self.comp_source is not None else None
        if comp is None:
            return queries
        return comp[np.asarray(queries, dtype=np.int64)].astype(np.int32)

    def query(self, u: int, v: int) -> bool:
        """Single host query (prefilters + rank-ordered sorted merge)."""
        if self.comp_source is not None:
            comp = self.comp_source()
            u, v = int(comp[u]), int(comp[v])
        if u == v:
            return True
        if (self.quarantine_out is not None and self.quarantine_out[u]) or (
                self.quarantine_in is not None and self.quarantine_in[v]):
            with self._stats_lock:
                self.degradation["quarantined"] += 1
                self.degradation["searched"] += 1
            _DEGRADED_KIND["quarantined"].inc()
            _DEGRADED_KIND["searched"].inc()
            return bool(self._search_batch(np.asarray([[u, v]]))[0])
        if self.level is not None and self.level[u] >= self.level[v]:
            return False
        o = self.oracle
        if o.out_len[u] == 0 or o.in_len[v] == 0:
            return False
        return o.query(u, v)

    def query_batch(self, queries: np.ndarray, backend: Optional[str] = None,
                    deadline: Optional[float] = None) -> np.ndarray:
        """Answer int[B, 2] queries -> bool[B].

        With ``comp_source`` set, queries are original vertex ids.
        ``deadline`` (absolute ``time.monotonic()`` seconds): a batch already
        past it skips the device attempt and takes the host merge (counted
        as ``deadline_to_host``).  Deadlines never change verdicts.
        """
        queries = self._map_ids(np.asarray(queries))
        queries = np.ascontiguousarray(np.asarray(queries, dtype=np.int32))
        backend = self.backend if backend is None else select_backend(backend, self.device)
        o = self.oracle
        out = np.zeros(queries.shape[0], dtype=bool)
        degraded = dict(_ZERO_DEGRADATION)

        # ladder rung 0 (when needed): queries touching quarantined label
        # rows bypass the prefilters too — they read the very state that
        # failed verification
        label_idx = np.arange(queries.shape[0])
        if self.quarantine_out is not None or self.quarantine_in is not None:
            qm = np.zeros(queries.shape[0], dtype=bool)
            if self.quarantine_out is not None:
                qm |= self.quarantine_out[queries[:, 0]]
            if self.quarantine_in is not None:
                qm |= self.quarantine_in[queries[:, 1]]
            q_idx = np.nonzero(qm)[0]
            if q_idx.size:
                degraded["quarantined"] += int(q_idx.size)
                degraded["searched"] += int(q_idx.size)
                out[q_idx] = self._search_batch(queries[q_idx])
                label_idx = np.nonzero(~qm)[0]

        pf = apply_prefilters(queries[label_idx], o.out_len, o.in_len, self.level)
        out[label_idx] = pf.decided & pf.value
        rest_idx = label_idx[~pf.decided]
        stats = {
            "backend": backend,
            "n_queries": int(queries.shape[0]),
            "n_prefiltered": int(label_idx.shape[0] - rest_idx.size),
            "tiers": [],
            "degraded": degraded,
        }
        sp = trace.span("engine.batch", cat="engine", args={
            "backend": backend, "n": stats["n_queries"],
            "prefiltered": stats["n_prefiltered"]}) if ON.enabled else trace.NOOP_SPAN
        with sp:
            if rest_idx.size:
                rest = queries[rest_idx]
                if backend == "host":
                    res = self._host_batch(rest)
                elif deadline is not None and time.monotonic() > deadline:
                    degraded["deadline_to_host"] += int(rest.shape[0])
                    sp.event("degrade", kind="deadline_to_host", n=int(rest.shape[0]))
                    res = self._host_batch(rest)
                else:
                    try:
                        res = self._device_batch(
                            rest, use_kernel=backend == "kernel", stats=stats)
                    except inject.SimulatedFailure as e:  # ladder: device -> host merge
                        degraded["device_to_host"] += int(rest.shape[0])
                        sp.event("degrade", kind="device_to_host",
                                 n=int(rest.shape[0]), error=type(e).__name__)
                        warnings.warn(
                            f"{backend!r} backend failed ({type(e).__name__}: {e}); "
                            f"serving {rest.shape[0]} queries on the host merge path",
                            stacklevel=2)
                        res = self._host_batch(rest)
                out[rest_idx] = res
            self._tally(stats, degraded)
            return out

    def _host_batch(self, rest: np.ndarray) -> np.ndarray:
        o = self.oracle
        return np.fromiter((o.query(int(u), int(v)) for u, v in rest), dtype=bool,
                           count=rest.shape[0])

    def _tally(self, stats: dict, degraded: dict) -> None:
        """Publish a finished batch: counters + last_stats flip together."""
        with self._stats_lock:
            for k, v in degraded.items():
                self.degradation[k] += v
            self.last_stats = stats
        _M_QUERIES.inc(stats["n_queries"])
        _M_PREFILTERED.inc(stats["n_prefiltered"])
        for k, v in degraded.items():
            if v:
                _DEGRADED_KIND[k].inc(v)

    # ------------------------------------------------------------ backends

    def _to_device(self, q: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(q, dtype=np.int32)).to(self.device)

    def _device_batch(self, rest: np.ndarray, use_kernel: bool,
                      stats: Optional[dict] = None) -> np.ndarray:
        # chaos hook: an injected device failure here exercises the ladder's
        # device -> host downgrade in query_batch
        inject.fire("serve.device_dispatch", backend="kernel" if use_kernel else "dense")
        if stats is None:
            stats = {"tiers": []}   # direct callers outside query_batch
        o, lo, li, widths = self.oracle, self._lo, self._li, self.widths
        if not self.bucketing:
            with trace.span("device_call", cat="device", annotate=True,
                            args={"rows": int(rest.shape[0])} if ON.enabled else None):
                r = serve_step(lo, li, self._to_device(rest), use_kernel=use_kernel)
            return r.cpu().numpy()
        plan = plan_batch(rest, o.out_len, o.in_len, widths, min_tile=self.min_tile)
        results = []
        for tier in plan.tiers:
            q = self._to_device(plan.padded_queries(rest, tier))
            with trace.span("device_call", cat="device", annotate=True,
                            args={"width": tier.width, "rows": tier.rows}
                            if ON.enabled else None):
                results.append(_tier_intersect(lo, li, q, tier.width, use_kernel))
            stats["tiers"].append(
                {"width": tier.width, "count": int(tier.idx.size), "rows": tier.rows}
            )
        return plan.scatter([r.cpu().numpy() for r in results])
