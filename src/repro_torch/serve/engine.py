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
  kernel  the hand-written CUDA kernel ``kernels.ops.ServeBatch`` (K1's batch
          form): the id range check, the prefilters, the tier choice and the
          intersection of a whole batch in one launch, with one copy in and
          one copy out (on a CPU engine the wrapper runs its plain version)

  sharded      labels whole on every rank, the batch split over the mesh's
               data axes: each data rank answers its slice with K1's tier
               form (``kernels.ops.tier_intersect``) and the slices are
               gathered, so every rank gets the whole answer
  sharded_hop  each model rank holds a contiguous column block of both
               label matrices (the labels-larger-than-one-device mode): it
               gathers its block of the slice's rows, all-gathers the
               ``L_in`` rows over the model axis, intersects with the tier
               form, and the hits are ORed over the model axis, then
               gathered over the data axes

``backend="auto"`` picks ``sharded`` when a mesh is given, ``kernel`` when
the engine's device is CUDA and ``dense`` on the CPU.  The sharded backends
run one process a rank (``repro_torch.launch.mesh``): every rank of the
mesh makes the same calls on the same queries, where JAX's engine runs the
mesh from one controller.

Under a memory budget (``set_budget``, ``serve.budget``) every backend reads
the truncated store and verdicts become three-valued: a false verdict with
both rows truncated is uncertain and goes to exact search.  ``host`` and
``dense`` mark those queries on the host, ``kernel`` in K1's batch form.

Verdicts, prefilter counts, tier stats and degradation counters equal the
JAX engine's on the same labels and queries.
"""
from __future__ import annotations

import copy
import threading
import time
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.ft import inject
from repro_torch.graph.csr import INVALID
from repro_torch.kernels import ops, ref
from repro_torch.obs import metrics, trace
from repro_torch.obs.state import ON
from repro_torch.serve.planner import plan_batch, tier_stats, tier_widths
from repro_torch.serve.prefilter import apply_prefilters

BACKENDS = ("host", "dense", "kernel", "sharded", "sharded_hop")


def select_backend(name: Optional[str] = None, device="cuda", mesh=None) -> str:
    """Resolve a backend name ('auto'/None = sharded with a mesh, else
    kernel on CUDA and dense on CPU)."""
    if name in (None, "auto"):
        if mesh is not None:
            return "sharded"
        return "kernel" if torch.device(device).type == "cuda" else "dense"
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected one of {BACKENDS}")
    if name in ("sharded", "sharded_hop") and mesh is None:
        raise ValueError(f"backend {name!r} requires a mesh")
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


# ------------------------------------------------------------ sharded modes


def _placements(mesh, sharded: dict) -> tuple:
    """DTensor placements over ``mesh``'s axes: ``sharded`` maps an axis to
    the ``Shard`` dim it splits, every other axis ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(sharded[ax]) if ax in sharded else Replicate()
                 for ax in mesh.mesh_dim_names)


def _data_slice(queries: torch.Tensor, dg) -> torch.Tensor:
    """This data rank's contiguous slice of a batch padded to a multiple of
    the data shards."""
    B = queries.shape[0]
    if B % dg.size:
        raise ValueError(f"a batch of {B} does not split over {dg.size} data shards; "
                         "pad it to a multiple (QueryEngine does)")
    b = B // dg.size
    return queries[dg.index * b:(dg.index + 1) * b]


def make_sharded_serve_step(mesh, data_axes=("pod", "data")):
    """Production serve step: labels whole on every rank, queries split over
    ``data_axes``.  Returns ``(fn, in_placements, out_placement)``, JAX's
    triple with DTensor placements as its descriptive second and third
    items.

    ``fn(L_out, L_in, queries)`` takes int32 label matrices and an int32[B,
    2] batch (B a multiple of the data shards) on this rank's device, answers
    its data slice with K1's tier form at the full width and returns the
    whole bool[B] on every rank (the slices gathered over ``data_axes``).
    Every rank calls it with the same arguments."""
    from repro_torch.launch.mesh import axis_group, gather_rows

    dg = axis_group(mesh, data_axes)
    data = {ax: 0 for ax in data_axes}

    def fn(L_out, L_in, queries):
        q = _data_slice(queries, dg)
        hit = ops.tier_intersect(L_out, L_in, q, max(L_out.shape[1], L_in.shape[1]))
        return gather_rows(hit, dg)

    labels = _placements(mesh, {})
    return fn, (labels, labels, _placements(mesh, data)), _placements(mesh, data)


class _ColumnBlocks:
    """This model rank's contiguous column blocks of the label matrices it
    was last given, cut once a matrix pair (and again when the engine
    swaps labels: a refresh, a budget)."""

    def __init__(self, mg):
        self.mg = mg
        self._key = None
        self._blocks = None

    def __call__(self, L_out: torch.Tensor, L_in: torch.Tensor) -> tuple:
        if self._key is None or self._key[0] is not L_out or self._key[1] is not L_in:
            blocks = []
            for name, L in (("L_out", L_out), ("L_in", L_in)):
                w = L.shape[1]
                if w % self.mg.size:
                    # JAX's jit refuses the sharding too (a ValueError, which
                    # its engine's catch-all serves on the host)
                    raise ValueError(
                        f"the model axis ({self.mg.size} ranks) does not divide the "
                        f"width of {name} ({w})")
                c = w // self.mg.size
                blocks.append(L[:, self.mg.index * c:(self.mg.index + 1) * c].contiguous())
            self._key, self._blocks = (L_out, L_in), tuple(blocks)
        return self._blocks


def make_hop_sharded_serve_step(mesh, model_axis="model", data_axes=("pod", "data")):
    """Large-graph variant: label MATRICES split over ``model_axis`` along
    the hop dimension (each model rank holds a contiguous column block of
    every row), queries over ``data_axes``.  Returns ``(fn, in_placements,
    out_placement)`` as ``make_sharded_serve_step`` does.

    ``fn(L_out, L_in, queries)``: for its data slice a rank gathers its
    column block of the ``L_out`` rows and of the ``L_in`` rows, gathers the
    ``L_in`` rows' blocks over the model axis (JAX's implicit all-gather),
    intersects its ``L_out`` block with the whole ``L_in`` rows in K1's tier
    form, ORs the hits over the model axis and gathers them over the data
    axes.  The model axis must divide both label widths (``ValueError``).
    The blocks are cut from the matrices on first use and kept."""
    from repro_torch.launch.mesh import axis_group, gather_rows, or_over

    dg = axis_group(mesh, data_axes)
    mg = axis_group(mesh, (model_axis,))
    blocks = _ColumnBlocks(mg)

    def fn(L_out, L_in, queries):
        lo, li = blocks(L_out, L_in)
        q = _data_slice(queries, dg).long()
        a = lo.index_select(0, q[:, 0])                       # [b, Lo / M]
        b_part = li.index_select(0, q[:, 1])                  # [b, Li / M]
        # the model ranks' blocks side by side: [M, b, Li / M] -> [b, Li]
        b_full = gather_rows(b_part.unsqueeze(0), mg).permute(1, 0, 2)
        b_full = b_full.reshape(b_part.shape[0], -1).contiguous()
        rows = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
        hit = ops.tier_intersect(a, b_full, torch.stack([rows, rows], 1),
                                 max(a.shape[1], b_full.shape[1]))
        return gather_rows(or_over(hit, mg), dg)

    data = {ax: 0 for ax in data_axes}
    labels = _placements(mesh, {model_axis: 1})
    return fn, (labels, labels, _placements(mesh, data)), _placements(mesh, data)


# ----------------------------------------------------------------- engine

# every downgrade the ladder can count; stats()/reset_stats() and the
# per-batch tallies all start from this shape so no consumer ever sees a
# partially populated counter dict (the same keys as the JAX engine's)
_ZERO_DEGRADATION = {
    "device_to_host": 0,   # device backend failed -> host merge
    "deadline_to_host": 0, # batch past deadline -> skip device
    "searched": 0,         # labels unusable -> exact bidirectional search
    "quarantined": 0,      # queries that touched quarantined label rows
    "uncertain": 0,        # budget-truncated miss, BOTH rows cut -> search
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
_M_UNCERTAIN = metrics.counter(
    "engine_verdict_uncertain_total",
    "budget-truncated label misses that could not be proven NO and routed "
    "to the exact-search rung")


class _BudgetView(NamedTuple):
    """Everything a batch reads under a budget, made whole in ``set_budget``
    and read once per batch: a re-truncation landing between two batches
    can never serve one from new labels with old widths or masks."""
    store: object                 # serve.budget.TruncatedStore
    L_out: torch.Tensor           # the store's labels on the engine's device
    L_in: torch.Tensor
    widths: list                  # tier widths of the truncated lengths
    serve_batch: "ops.ServeBatch"  # K1's batch form bound to all of it
    trunc_out: torch.Tensor       # packed truncation masks on the device
    trunc_in: torch.Tensor


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
    mesh : optional ``DeviceMesh`` (``repro_torch.launch.mesh.form_mesh``)
        Required for the sharded backends; every rank of it runs this engine
        on the same labels and makes the same calls.
    data_axes, model_axis
        The mesh axes the batch and (``sharded_hop``) the label columns are
        split over; ``data_axes`` defaults to every axis but
        ``model_axis``, as in the JAX engine.
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
        Where the label matrices live and the dense/kernel/sharded backends
        run (this rank's card under a mesh).  Defaults to ``"cuda"``; raises
        ``RuntimeError`` when torch sees no CUDA device, unless
        ``device="cpu"`` is given.

    Degradation ladder
    ------------------
    A device failure injected at ``serve.device_dispatch`` (``ft.inject``)
    downgrades the whole sub-batch to the host merge path (same labels,
    same verdicts, counted as ``device_to_host``, as the JAX engine counts
    it).  A real failure of the device path (the kernel does not build, a
    launch, a CUDA call or a collective fails) is raised, never served on
    the CPU: the JAX engine's catch-all would hide a broken kernel behind
    correct verdicts.  Under a mesh the hook fires before the first
    collective, so an injected failure takes every rank down the same rung.
    A query touching a *quarantined* label row (``set_quarantine``) skips
    labels entirely and runs the exact online search.  Under a budget
    (``set_budget``) a false verdict with both rows truncated is uncertain
    and runs the exact online search too.  Every rung returns correct
    verdicts; ``self.degradation`` counts how often each downgrade fired.
    """

    def __init__(
        self,
        oracle,
        backend: str = "auto",
        level: Optional[np.ndarray] = None,
        mesh=None,
        data_axes: Optional[Sequence[str]] = None,
        model_axis: str = "model",
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
        self.mesh = mesh
        self.backend = select_backend(backend, self.device, mesh)
        # own copy: the owner may keep mutating its working level array
        self.level = None if level is None else np.array(level, dtype=np.int32)
        self.bucketing = bucketing
        self.min_tile = int(min_tile)
        self.n_tiers = int(n_tiers)
        if data_axes is None and mesh is not None:
            from repro_torch.launch.mesh import axes_except

            data_axes = axes_except(mesh, model_axis)
        self.data_axes = data_axes
        self.model_axis = model_axis
        self._sharded_fns: dict = {}
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
        self._serve_batch = None   # ops.ServeBatch, made on the first kernel batch
        self._budget_view: Optional[_BudgetView] = None

    # ---------------------------------------------------------- publishing

    def refresh(self, oracle, level: Optional[np.ndarray] = None,
                epoch: Optional[int] = None, fallback_graph=None) -> None:
        """Swap in a newly published label snapshot (epoch invalidation).

        Device labels, the tier-width plan and the cached ``ServeBatch`` op
        refresh ONLY here, never mid-batch.  The previous epoch's fallback
        graph, load-time quarantine and budget view (cut from the OLD
        labels; a ``BudgetController`` re-applies its budget) are dropped.
        """
        with self._stats_lock:   # a kernel batch may be making the op
            self.oracle = oracle
            if level is not None:
                self.level = np.array(level, dtype=np.int32)  # copy: see __init__
            self._lo, self._li = oracle.device_labels(self.device)
            self.widths = tier_widths(
                oracle.out_len, oracle.in_len, oracle.max_label_len, n_tiers=self.n_tiers
            )
            self._serve_batch = None
        self.epoch = self.epoch + 1 if epoch is None else int(epoch)
        _M_EPOCH.set(self.epoch)
        if fallback_graph is not None:
            self._fallback_graph = fallback_graph
        self._fallback_csr = None
        self.quarantine_out = None
        self.quarantine_in = None
        self._budget_view = None

    # ------------------------------------------------------- observability

    def stats(self) -> dict:
        """Consistent snapshot of the engine's serving state, key for key
        the JAX engine's."""
        bv = self._budget_view
        with self._stats_lock:
            return {
                "epoch": self.epoch,
                "backend": self.backend,
                "widths": list(self.widths),
                "n_quarantined": int(
                    (0 if self.quarantine_out is None else int(self.quarantine_out.sum()))
                    + (0 if self.quarantine_in is None else int(self.quarantine_in.sum()))),
                "budget": None if bv is None else {
                    "budget_bytes": bv.store.budget_bytes,
                    "resident_bytes": bv.store.resident_bytes,
                    "rank_cut": bv.store.rank_cut,
                    "n_truncated_rows": int(bv.store.truncated_out.sum()
                                            + bv.store.truncated_in.sum()),
                },
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
        # K1's batch form skips the quarantined rows' layout check (a
        # non-strict load zero-fills them): rebind it to the new quarantine
        with self._stats_lock:
            self._serve_batch = None
        bv = self._budget_view
        if bv is not None:
            self.set_budget(bv.store)

    @property
    def budget_store(self):
        """The active ``TruncatedStore`` (None = serving the full labels)."""
        bv = self._budget_view
        return None if bv is None else bv.store

    def set_budget(self, store) -> None:
        """Install (or with None, remove) a budget-truncated label store.

        The engine keeps serving ``self.oracle``'s graph; only the label
        matrices the backends read switch to the truncated store, uploaded
        to the engine's device with its packed truncation masks, a tier-width
        plan fit to the truncated lengths and K1's batch form bound to them.
        All of it swaps as one tuple, read once per batch.  The full store's
        device copy stays, as in the JAX engine."""
        if store is None:
            self._budget_view = None
            return
        t = store.oracle
        lo, li = t.device_labels(self.device)
        widths = tier_widths(t.out_len, t.in_len, t.max_label_len, n_tiers=self.n_tiers)
        masks = [torch.from_numpy(m).to(self.device) for m in store.packed_masks()]
        sb = self._make_serve_batch(t, lo, li, widths, *masks)
        self._budget_view = _BudgetView(store, lo, li, widths, sb, *masks)

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
        bv = self._budget_view
        o = self.oracle if bv is None else bv.store.oracle
        # an empty TRUNCATED row is only a proven miss when at most one side
        # was cut: fall through to the uncertain check
        if o.out_len[u] != 0 and o.in_len[v] != 0 and o.query(u, v):
            return True          # hits on surviving prefixes are proven YES
        if bv is not None and bv.store.truncated_out[u] and bv.store.truncated_in[v]:
            # miss with BOTH rows cut: uncertain -> exact search rung
            with self._stats_lock:
                self.degradation["uncertain"] += 1
                self.degradation["searched"] += 1
            _DEGRADED_KIND["uncertain"].inc()
            _DEGRADED_KIND["searched"].inc()
            _M_UNCERTAIN.inc()
            return bool(self._search_batch(np.asarray([[u, v]]))[0])
        return False

    def query_batch(self, queries: np.ndarray, backend: Optional[str] = None,
                    deadline: Optional[float] = None) -> np.ndarray:
        """Answer int[B, 2] queries -> bool[B].

        With ``comp_source`` set, queries are original vertex ids.
        ``deadline`` (absolute ``time.monotonic()`` seconds): a batch already
        past it skips the device attempt and takes the host merge (counted
        as ``deadline_to_host``).  Deadlines never change verdicts.

        The ``kernel`` backend serves the batch's label queries in one call
        of ``ops.ServeBatch`` (prefilters, tier choice, intersection and,
        under a budget, the uncertain mark in one launch); the others run
        the prefilters, the planner and the budget's epilogue here.
        """
        queries = self._map_ids(np.asarray(queries))
        queries = np.ascontiguousarray(np.asarray(queries, dtype=np.int32))
        backend = self.backend if backend is None else select_backend(
            backend, self.device, self.mesh)
        # the budget view, captured ONCE: the batch reads one store, its
        # widths, masks and op, whatever set_budget does meanwhile
        bv = self._budget_view
        o = self.oracle if bv is None else bv.store.oracle
        out = np.zeros(queries.shape[0], dtype=bool)
        degraded = dict(_ZERO_DEGRADATION)

        # ladder rung 0 (when needed): queries touching quarantined label
        # rows bypass the prefilters too — they read the very state that
        # failed verification
        label_idx = None   # None: every query reads labels
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
        lq = queries if label_idx is None else queries[label_idx]

        stats = {
            "backend": backend,
            "n_queries": int(queries.shape[0]),
            "n_prefiltered": 0,
            "tiers": [],
            "degraded": degraded,
        }
        # a batch past its deadline takes the host path below, kernel or not
        fused = backend == "kernel" and (deadline is None or time.monotonic() <= deadline)
        if not fused:
            pf = apply_prefilters(lq, o.out_len, o.in_len, self.level)
            lout = pf.decided & pf.value
            rest_idx = np.nonzero(~pf.decided)[0]
            stats["n_prefiltered"] = int(lq.shape[0] - rest_idx.size)
        sp = trace.span("engine.batch", cat="engine", args={
            "backend": backend, "n": stats["n_queries"]}) if ON.enabled else trace.NOOP_SPAN
        with sp:
            unc_idx = None   # uncertain label queries (indices into lq)
            if fused:
                lout, unc_idx = self._fused_batch(lq, stats, sp, bv)
            elif rest_idx.size:
                rest = lq[rest_idx]
                if backend == "host":
                    res = self._host_batch(rest, o)
                elif deadline is not None and self._past_deadline(deadline, backend):
                    degraded["deadline_to_host"] += int(rest.shape[0])
                    sp.event("degrade", kind="deadline_to_host", n=int(rest.shape[0]))
                    res = self._host_batch(rest, o)
                else:
                    try:
                        if backend == "dense":
                            res = self._device_batch(rest, stats=stats, view=bv)
                        else:
                            res = self._sharded_batch(rest, backend, view=bv)
                    except inject.SimulatedFailure as e:  # ladder: device -> host merge
                        res = self._degrade_to_host(rest, backend, e, degraded, sp, o)
                lout[rest_idx] = res
            if not fused and bv is not None and bv.store.any_truncated:
                # three-valued epilogue: a false verdict from the labels
                # (backend miss OR emptiness prefilter on a cut-to-empty row)
                # is only proven when at most one row was truncated; the
                # same-vertex and level prefilters are graph facts, exact
                unc = (bv.store.truncated_out[lq[:, 0]]
                       & bv.store.truncated_in[lq[:, 1]] & ~lout)
                unc &= lq[:, 0] != lq[:, 1]
                if self.level is not None:
                    unc &= self.level[lq[:, 0]] < self.level[lq[:, 1]]
                unc_idx = np.flatnonzero(unc)
            if unc_idx is not None and unc_idx.size:
                degraded["uncertain"] += int(unc_idx.size)
                degraded["searched"] += int(unc_idx.size)
                sp.event("degrade", kind="uncertain", n=int(unc_idx.size))
                lout[unc_idx] = self._search_batch(lq[unc_idx])
            if label_idx is None:
                out = lout
            else:
                out[label_idx] = lout
            sp.set(prefiltered=stats["n_prefiltered"])
            self._tally(stats, degraded)
            return out

    def _past_deadline(self, deadline: float, backend: str) -> bool:
        """Whether the batch is past ``deadline``.  On a sharded backend the
        ranks of the mesh agree first (an OR over the data axes, then over
        the model axis), before any collective of the batch: one rank past
        its deadline takes every rank to the host merge, so no rank waits in
        a collective that another skipped, or pairs it with its next
        batch's, and every rank counts the batch alike."""
        past = time.monotonic() > deadline
        if backend not in ("sharded", "sharded_hop"):
            return past
        from repro_torch.launch.mesh import axis_group, or_over

        flag = or_over(torch.tensor([past], device=self.device),
                       axis_group(self.mesh, self.data_axes))
        if self.model_axis in self.mesh.mesh_dim_names:
            flag = or_over(flag, axis_group(self.mesh, (self.model_axis,)))
        return bool(flag[0])

    def _degrade_to_host(self, rest: np.ndarray, backend: str, e: Exception, degraded: dict,
                         sp, o) -> np.ndarray:
        """The ladder's device -> host rung: ``rest`` on the host merge."""
        degraded["device_to_host"] += int(rest.shape[0])
        sp.event("degrade", kind="device_to_host", n=int(rest.shape[0]),
                 error=type(e).__name__)
        warnings.warn(
            f"{backend!r} backend failed ({type(e).__name__}: {e}); "
            f"serving {rest.shape[0]} queries on the host merge path",
            stacklevel=3)
        return self._host_batch(rest, o)

    def _host_batch(self, rest: np.ndarray, o) -> np.ndarray:
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
        if degraded["uncertain"]:
            _M_UNCERTAIN.inc(degraded["uncertain"])

    # ------------------------------------------------------------ backends

    def _make_serve_batch(self, o, lo, li, widths, trunc_out=None,
                          trunc_in=None) -> "ops.ServeBatch":
        """K1's batch form bound to labels ``lo``/``li`` of ``o`` on the
        engine's device, its lengths, the engine's levels and ``widths``
        (the quarantined rows, which no kernel batch reads, left unchecked)."""
        def t(a, dtype=np.int32):
            if a is None:
                return None
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(self.device)

        return ops.ServeBatch(lo, li, t(o.out_len), t(o.in_len), t(self.level), widths,
                              trunc_out, trunc_in, unread_out=t(self.quarantine_out, bool),
                              unread_in=t(self.quarantine_in, bool))

    def _serve_batch_op(self) -> "ops.ServeBatch":
        """K1's batch form bound to the full labels, made (and its layout
        checked) on the first unbudgeted kernel batch."""
        if self._serve_batch is None:
            with self._stats_lock:
                if self._serve_batch is None:
                    self._serve_batch = self._make_serve_batch(
                        self.oracle, self._lo, self._li, self.widths)
        return self._serve_batch

    def _fused_batch(self, lq: np.ndarray, stats: dict, sp,
                     bv: Optional[_BudgetView]) -> tuple:
        """The ``kernel`` backend: every label query of the batch decided in
        one ``ServeBatch`` call (the budget view's, under a budget), its codes
        turned into verdicts, stats and the indices of the queries the kernel
        marked uncertain (None without a budget)."""
        sb = self._serve_batch_op() if bv is None else bv.serve_batch
        with trace.span("device_call", cat="device", annotate=True,
                        args={"rows": int(lq.shape[0])} if ON.enabled else None):
            codes = sb(lq)
        unc_idx = None
        if bv is not None:
            unc_idx = np.flatnonzero(codes & ops.SERVE_BATCH_UNCERTAIN)
            codes &= ~np.uint8(ops.SERVE_BATCH_UNCERTAIN)
        fates = np.bincount(codes >> 1, minlength=1 + len(sb.widths))
        stats["n_prefiltered"] = int(fates[0])
        verdict = (codes & 1).view(bool)
        if fates[0] == codes.size:
            return verdict, unc_idx
        try:
            # chaos hook, once per batch with a residue, as in _device_batch
            inject.fire("serve.device_dispatch", backend="kernel")
        except inject.SimulatedFailure as e:  # ladder: device -> host merge
            # the host merge reads the same labels, so the kernel's marks hold
            rest_idx = np.nonzero(codes > 1)[0]
            o = self.oracle if bv is None else bv.store.oracle
            verdict[rest_idx] = self._degrade_to_host(lq[rest_idx], "kernel", e,
                                                      stats["degraded"], sp, o)
            return verdict, unc_idx
        if self.bucketing:
            stats["tiers"] = tier_stats(fates[1:], sb.widths, self.min_tile)
        return verdict, unc_idx

    def _to_device(self, q: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(q, dtype=np.int32)).to(self.device)

    def _device_batch(self, rest: np.ndarray, stats: Optional[dict] = None,
                      view: Optional[_BudgetView] = None) -> np.ndarray:
        """The ``dense`` backend: the planner's tiers through
        ``ref.tier_intersect_ref`` on the engine's device (over the budget
        view's store when one is given)."""
        # chaos hook: an injected device failure here exercises the ladder's
        # device -> host downgrade in query_batch
        inject.fire("serve.device_dispatch", backend="dense")
        if stats is None:
            stats = {"tiers": []}   # direct callers outside query_batch
        if view is not None:
            o, lo, li, widths = view.store.oracle, view.L_out, view.L_in, view.widths
        else:
            o, lo, li, widths = self.oracle, self._lo, self._li, self.widths
        if not self.bucketing:
            with trace.span("device_call", cat="device", annotate=True,
                            args={"rows": int(rest.shape[0])} if ON.enabled else None):
                r = serve_step(lo, li, self._to_device(rest))
            return r.cpu().numpy()
        plan = plan_batch(rest, o.out_len, o.in_len, widths, min_tile=self.min_tile)
        results = []
        for tier in plan.tiers:
            q = self._to_device(plan.padded_queries(rest, tier))
            with trace.span("device_call", cat="device", annotate=True,
                            args={"width": tier.width, "rows": tier.rows}
                            if ON.enabled else None):
                results.append(ref.tier_intersect_ref(lo, li, q, tier.width))
            stats["tiers"].append(
                {"width": tier.width, "count": int(tier.idx.size), "rows": tier.rows}
            )
        return plan.scatter([r.cpu().numpy() for r in results])

    def _sharded_batch(self, rest: np.ndarray, backend: str,
                       view: Optional[_BudgetView] = None) -> np.ndarray:
        """The ``sharded`` and ``sharded_hop`` backends: the batch padded with
        zero rows to a multiple of the data shards (as the JAX engine pads
        it), answered over the mesh, every rank getting every verdict."""
        from repro_torch.launch.mesh import axis_group

        # chaos hook, before the first collective: every rank fires alike
        inject.fire("serve.device_dispatch", backend=backend)
        lo, li = (self._lo, self._li) if view is None else (view.L_out, view.L_in)
        fn = self._sharded_fns.get(backend)
        if fn is None:
            if backend == "sharded":
                fn, _, _ = make_sharded_serve_step(self.mesh, data_axes=self.data_axes)
            else:
                fn, _, _ = make_hop_sharded_serve_step(
                    self.mesh, model_axis=self.model_axis, data_axes=self.data_axes)
            self._sharded_fns[backend] = fn
        shards = axis_group(self.mesh, self.data_axes).size
        B = rest.shape[0]
        pad = (-B) % shards
        if pad:
            rest = np.concatenate([rest, np.zeros((pad, 2), dtype=rest.dtype)], axis=0)
        with trace.span("device_call", cat="device", annotate=True,
                        args={"rows": int(rest.shape[0])} if ON.enabled else None):
            res = fn(lo, li, self._to_device(rest))
        return res[:B].cpu().numpy()
