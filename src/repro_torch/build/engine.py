"""Distribution-Labeling construction engine (paper §5, Algorithm 2).

The port's construction engine, held byte for byte against
``repro.build.engine``.  Its implementations all give the same finalized
labels:

``impl="reference"``
    The scalar path: per-vertex pruned BFS with python sets + deque (via
    ``traverse.pruned_bfs_distribute``), finalized into rank-space label
    matrices.  The ground truth.

``impl="wave"`` (alias ``"bitset"``)
    The host bit-parallel engine.  The §5.2 rank order is partitioned into
    *waves* of mutually unreachable vertices (``waves.wave_schedule``); each
    wave's up-to-256 pruned BFS sweeps run as ONE batched level-synchronous
    sweep over packed uint64 member masks:

      * frontier / visited state: uint64[n, K] — bit j = "wave member j",
      * prune test: ``hop_mask`` maps hop rank h -> mask of members whose
        source label contains h, so Algorithm 2's per-vertex set probe
        ``L_out(u) ∩ L_in(v_i) != ∅`` becomes one ragged gather of u's
        label entries plus a word-wide OR-reduce — no per-element set
        operations,
      * label append: grouped vectorized writes into ``_LabelStore`` (dense
        int32 head rows + side lists for the rare deep rows, so a handful
        of hub labels never force full-matrix growth copies).

    Why waves are exact: within a wave no member reaches another, so no
    member's append can appear in another member's prune source set (v_i in
    L_in(v_j) would require v_i -> v_j), and intra-wave ranks cannot occur
    in any wave-start label.  Hence every prune verdict equals the one the
    sequential loop would produce, and label *sets* match exactly; rows are
    sorted once at the end, giving byte-identical finalized labels.

``impl="speculative"``
    The host optimistic engine for dense-reachability families (citeseer,
    citeseerx, cit-Patents analogues), where true conflicts occur every
    ~1-2 consecutive ranks and exact waves cannot amortize anything.  The
    scheduler (``waves.speculative_schedule``) emits rank-consecutive
    chunks WITHOUT proving mutual unreachability; the engine runs the same
    fused bitset sweep for the whole chunk, then a *certification pass*
    (word-level primitives in ``bitset.py``) detects prune-order
    violations — members whose pruned BFS should have seen a lower-ranked
    wave-mate's freshly distributed hops.  Violated members are rolled back
    in the ``_LabelStore`` (append-only rows make truncation-by-watermark
    cheap) and corrected in rank order from the chunk's append log —
    exactly the sequential §5.2 semantics.  Chunk size adapts to the
    observed violation rate (bounded optimism), and a worst-case bailout
    degenerates to the scalar loop when speculation keeps losing.

``impl="device"``
    The device wave engine (``engine_device.py``, the port of
    ``repro.build.engine_jax``): the wave schedule of ``waves.wave_schedule``
    with each wave's sweeps on the build's ``device`` — through the
    hand-written K2 kernel on a card, its plain version on the CPU; with
    ``mesh=`` each BFS level is split over the mesh's data axes.

The host engines (``reference``, ``wave``, ``speculative``) are numpy
copies of the JAX package's and run on the host whatever ``device`` says.

``impl="auto"`` routes as the JAX engine does: "reference" below 4096
vertices; "speculative" on a dense-reachability graph, or when the exact
schedule aborts or its mean wave is short; otherwise "device" on the
build's device (where JAX, on a host without an accelerator, picks its
host ``wave`` engine).

``checkpoint_dir=`` writes wave/chunk-granular checkpoints of the host
batched engines (``wave``, ``speculative``) through ``persist.blocks``; a
build resumed from one — in either package — finishes byte-identical to an
uninterrupted one.

Every oracle built here carries the JAX engine's ``build_stats``
breadcrumb: ``{"impl", "scheduler", "schedule_seconds", "sweep_seconds",
"n_waves", "stages", "stage_shares"}``, plus a ``"speculation"`` sub-dict
(chunks, members, violations, replays) when the speculative engine ran, a
``"checkpoint"`` sub-dict (``resumed_from``, ``written``) when
checkpointing was on, and a ``"device"`` sub-dict of sweep, BFS-level,
host-read and regrow counts when the device engine ran.
"""
from __future__ import annotations

import os
import re
import shutil
import time
import warnings
import zlib
from typing import Dict, List, Optional

import numpy as np

from repro_torch.build import bitset
# cone_resume_sweep is the engine's cone-scoped construction entry point
# (repro_torch.dynamic repairs labels through it); it lives in traverse.py
# beside the sibling scalar sweep it generalizes
from repro_torch.build.traverse import cone_resume_sweep, pruned_bfs_distribute  # noqa: F401
from repro_torch.build.waves import speculative_schedule, wave_schedule
from repro_torch.core.oracle import ReachabilityOracle, finalize_labels
from repro_torch.core.order import get_order
from repro_torch.ft import inject
from repro_torch.graph.csr import CSRGraph, INVALID
from repro_torch.obs import metrics, trace
from repro_torch.obs.state import ON

_PAD_MULTIPLE = 8
# below this vertex count the scalar reference path wins (numpy dispatch
# overhead dominates the batched sweeps)
_AUTO_WAVE_MIN = 4096
# impl="auto" leaves the wave engines for the speculative one when the
# schedule's mean wave is smaller than this — per-wave overhead would dominate
_AUTO_MIN_AVG_WAVE = 24.0
# impl="auto" routes straight to the speculative engine when the sampled
# mean forward cone covers at least this fraction of the graph: the paper's
# dense-reachability families sit two orders of magnitude above the
# tree/sparse families, and on the dense side even PROBING the exact
# scheduler is expensive (page closures span huge cones)
_AUTO_DENSE_REACH = 0.02
# speculative chunks cap at one uint64 word of members, so every mask op in
# the optimistic sweep (prune gather, certify, cleanup) runs on flat
# single-word arrays
_SPEC_CAP = 64
# the device engine's knobs and its mesh; any other extra kwarg is a TypeError
_DEVICE_KWARGS = frozenset({"l_max", "ell_width", "prune_cap", "mesh"})

# Registry families for construction progress.  Stage attribution also lands
# in ``build_stats["stages"]`` / ``["stage_shares"]``; the registry mirror
# makes a long-running build observable live.
_M_WAVES = metrics.counter(
    "build_waves_total", "completed schedule boundaries, by kind",
    labelnames=("kind",))
_WAVES_EXACT = _M_WAVES.labels(kind="exact")
_WAVES_SPEC = _M_WAVES.labels(kind="speculative")
_WAVES_BAILOUT = _M_WAVES.labels(kind="scalar_bailout")
_M_STAGE_SECONDS = metrics.counter(
    "build_stage_seconds_total", "cumulative construction seconds by stage",
    labelnames=("stage",))


def _sampled_reach_density(g: CSRGraph, samples: int = 12, seed: int = 0) -> float:
    """Mean forward-cone fraction over a few fixed-seed sample vertices —
    the cheap dense-reachability detector behind impl="auto" (a handful of
    plain BFS, deterministic for a given graph)."""
    from repro_torch.graph.reach import reachable_set

    rng = np.random.default_rng(seed)
    verts = rng.integers(0, g.n, samples)
    return float(np.mean([reachable_set(g, int(v)).sum() / g.n for v in verts]))


def build_distribution_labels(
    g: CSRGraph,
    order: Optional[np.ndarray] = None,
    order_name: str = "degree_product",
    impl: str = "auto",
    max_wave: int = 256,
    scheduler: str = "onepass",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 16,
    resume_dir: Optional[str] = None,
    waves: Optional[np.ndarray] = None,
    device="cuda",
    **device_kwargs,
) -> ReachabilityOracle:
    """Build the DL oracle for DAG ``g`` with the selected implementation.

    ``checkpoint_dir`` enables wave/chunk-granular construction checkpoints
    (every ``checkpoint_every`` schedule boundaries); ``resume_dir``
    (defaulting to ``checkpoint_dir``) is scanned for the latest complete
    checkpoint of the SAME build, which resumes mid-schedule and finishes
    byte-identical to an uninterrupted run.  Host batched impls only
    ("wave"/"speculative" — a resumed build adopts its checkpoint's impl).

    ``device`` is where the device engine runs (``"cuda"`` by default; it
    raises ``RuntimeError`` without a card); the host engines run on the
    host whatever it says.  ``waves`` hands the device engine a schedule
    instead of computing one.  ``device_kwargs`` (``l_max=``,
    ``ell_width=``, ``prune_cap=``, ``mesh=``) go to the device engine; any
    other name, or any of them with a host impl, is a ``TypeError`` — a
    typo'd tuning knob must not silently no-op.  ``mesh=`` (a
    ``DeviceMesh`` from ``repro_torch.launch.mesh``) splits each BFS level
    over the mesh's data axes, every rank building the same labels.
    """
    if impl not in ("auto", "reference", "ref", "wave", "bitset", "speculative",
                    "device"):
        raise ValueError(f"unknown construction impl {impl!r}")
    unknown = sorted(set(device_kwargs) - _DEVICE_KWARGS)
    if unknown:
        raise TypeError(f"unknown device-engine kwargs {unknown}; the device "
                        f"engine takes {sorted(_DEVICE_KWARGS)}")
    if (device_kwargs or waves is not None) and impl not in ("device", "auto"):
        raise TypeError(
            f"impl={impl!r} accepts no extra kwargs (got "
            f"{sorted(device_kwargs) + (['waves'] if waves is not None else [])}); "
            "they apply to the device engine only")
    if order is None:
        order = get_order(g, order_name)
    order = np.asarray(order, dtype=np.int64)
    spec_schedule = None
    t_sched = 0.0
    fingerprint = None
    restored = None
    if checkpoint_dir is not None or resume_dir is not None:
        fingerprint = _build_fingerprint(g, order, max_wave, scheduler)
    rdir = resume_dir if resume_dir is not None else checkpoint_dir
    if rdir is not None:
        restored = _BuildCheckpointer.latest(rdir, fingerprint)
    if restored is not None:
        ck_impl = restored[1]["impl"]
        if impl not in ("auto", ck_impl):
            warnings.warn(
                f"resuming from a {ck_impl!r} checkpoint; requested "
                f"impl={impl!r} ignored", stacklevel=2)
        impl = ck_impl
    if impl == "auto":
        if g.n < _AUTO_WAVE_MIN:
            impl = "reference"
        elif _sampled_reach_density(g) >= _AUTO_DENSE_REACH:
            # dense-reachability wall: true conflicts every ~1-2 consecutive
            # ranks degenerate the exact waves, and the exact scheduler is
            # itself expensive here — route straight to the speculative engine
            impl = "speculative"
        else:
            # sparse side: the exact schedule is the profitability probe —
            # tiny mean waves cannot amortize the batched sweeps and route to
            # the speculative engine too; long waves run on the device
            t0 = time.perf_counter()
            probe = wave_schedule(
                g, order, max_wave=max_wave, scheduler=scheduler,
                abort_below_avg=_AUTO_MIN_AVG_WAVE / 3,
            )
            t_sched = time.perf_counter() - t0
            if probe is None or g.n / probe.shape[0] < _AUTO_MIN_AVG_WAVE:
                impl = "speculative"
            else:
                impl = "device"
                if waves is None:
                    waves = probe
    if impl != "device" and (device_kwargs or waves is not None):
        # auto resolved to a host impl: the device knobs do not apply
        warnings.warn(
            f"device-engine kwargs {sorted(device_kwargs)} ignored: impl "
            f"resolved to {impl!r}", stacklevel=2)
        waves = None
    if impl == "ref":
        impl = "reference"
    if impl == "bitset":
        impl = "wave"
    if impl in ("wave", "device") and waves is None:
        t0 = time.perf_counter()
        waves = wave_schedule(g, order, max_wave=max_wave, scheduler=scheduler)
        t_sched += time.perf_counter() - t0
    if impl == "speculative":
        t0 = time.perf_counter()
        spec_schedule = speculative_schedule(g, order, max_wave=max_wave)
        t_sched += time.perf_counter() - t0
    ckpt = None
    if checkpoint_dir is not None:
        if impl in ("wave", "speculative"):
            ckpt = _BuildCheckpointer(checkpoint_dir, every=checkpoint_every)
        else:
            warnings.warn(
                f"construction checkpointing is host-batched only; "
                f"impl={impl!r} builds without checkpoints", stacklevel=2)
    spec_stats: dict = {}
    stage_seconds: dict = {}
    device_stats: dict = {}
    sweep_sp = (trace.span("build.sweep", cat="build",
                           args={"impl": impl, "n": g.n})
                if ON.enabled else trace.NOOP_SPAN)
    t0 = time.perf_counter()
    with sweep_sp:
        if impl == "reference":
            oracle = _build_reference(g, order)
        elif impl == "wave":
            oracle = _build_wave(g, order, max_wave=max_wave, waves=waves,
                                 ckpt=ckpt, fingerprint=fingerprint,
                                 restored=restored, stage_out=stage_seconds)
        elif impl == "speculative":
            oracle = _build_speculative(
                g, order, max_wave=max_wave, schedule=spec_schedule,
                stats_out=spec_stats, ckpt=ckpt, fingerprint=fingerprint,
                restored=restored, stage_out=stage_seconds,
            )
        else:
            from repro_torch.build.engine_device import distribution_labeling_device

            oracle = distribution_labeling_device(
                g, order=order, waves=waves, device=device,
                stats_out=device_stats, **device_kwargs)
    t_sweep = time.perf_counter() - t0
    if impl == "speculative":
        waves_n = int(spec_schedule.lengths.shape[0])
        scheduler = "speculative"
    else:
        waves_n = None if waves is None else int(waves.shape[0])
    object.__setattr__(oracle, "build_impl", impl)
    stats = {
        "impl": impl,
        "scheduler": scheduler if (waves is not None or impl == "speculative") else None,
        "schedule_seconds": round(t_sched, 4),
        "sweep_seconds": round(t_sweep, 4),
        "n_waves": waves_n,
    }
    # "schedule" and "sweep" partition the build; the other stages are
    # within-sweep shares (prune gather, label append, finalize,
    # certify/replay, checkpoint writes), so shares need not sum to 1
    stages = dict(stage_seconds)
    if ckpt is not None:
        stages["checkpoint"] = ckpt.save_seconds
    stages["schedule"] = t_sched
    stages["sweep"] = t_sweep
    total = t_sched + t_sweep
    stats["stages"] = {k: round(float(v), 4) for k, v in sorted(stages.items())}
    stats["stage_shares"] = {
        k: (round(float(v) / total, 4) if total > 0 else 0.0)
        for k, v in sorted(stages.items())
    }
    for k, v in stages.items():
        _M_STAGE_SECONDS.labels(stage=k).inc(float(v))
    if spec_stats:
        stats["speculation"] = spec_stats
    if ckpt is not None or restored is not None:
        stats["checkpoint"] = {
            "resumed_from": None if restored is None else int(restored[1]["done"]),
            "written": 0 if ckpt is None else ckpt.written,
        }
    if device_stats:
        stats["device"] = device_stats
    object.__setattr__(oracle, "build_stats", stats)
    return oracle


# ---------------------------------------------------------------------------
# reference scalar implementation
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# wave-scheduled bitset implementation
# ---------------------------------------------------------------------------


def _hop_rank(order: np.ndarray, n: int) -> np.ndarray:
    """rank[order[i]] = i — the rank-space remap shared by all impls."""
    hop_rank = np.empty(n, dtype=np.int32)
    hop_rank[order] = np.arange(n, dtype=np.int32)
    return hop_rank


class _LabelStore:
    """Ragged rank-space label rows under construction.

    Dense int32[n, cap] head rows (cap grows geometrically up to DEEP_CAP)
    hold columns < len; a few *deep* rows (hub labels can reach hundreds of
    hops while the average stays single-digit) spill their tail into python
    lists so they never force O(n x max_len) matrix growth.  No pad values
    anywhere: every reader walks columns < len.
    """

    DEEP_CAP = 64

    def __init__(
        self, n: int, deep_cap: int | None = None, null: int | None = None
    ):
        self.n = n
        # deep_cap tunes the dense-head/python-tail split: the speculative
        # builder raises it so hub rows (which sit in most frontiers on the
        # dense families) stay on the vectorized paths instead of paying the
        # per-row dict loops on every gather
        if deep_cap is not None:
            self.DEEP_CAP = deep_cap
        # ``null`` is a rank that indexes an always-zero row of every prune
        # table (builders pass the vertex count).  When set, slots beyond a
        # row's length always hold it — appends only write real slots, growth
        # and rollback refill — so rectangular gathers feed whole head rows
        # straight into the table with no tail-masking pass.
        self.null = null
        if null is None:
            self.mat = np.empty((n, _PAD_MULTIPLE), dtype=np.int32)
        else:
            self.mat = np.full((n, _PAD_MULTIPLE), null, dtype=np.int32)
        self.lens = np.zeros(n, dtype=np.int32)
        self.deep: Dict[int, List[int]] = {}
        # within-sweep stage attribution: the builders surface these as
        # ``build_stats["stages"]``
        self.stage_seconds: Dict[str, float] = {
            "prune_gather": 0.0, "label_append": 0.0, "finalize": 0.0}

    def _timed(self, stage: str, fn, *args):
        """Run a store hot spot under stage attribution (no-op clock when
        obs is disabled — the store methods themselves stay unchanged)."""
        if not ON.enabled:
            return fn(*args)
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.stage_seconds[stage] += time.perf_counter() - t0

    # -- writes ---------------------------------------------------------

    def append(self, verts: np.ndarray, counts: np.ndarray, vals: np.ndarray) -> None:
        """Append ``counts[k]`` rank values to row verts[k] (vals row-major)."""
        return self._timed("label_append", self._append, verts, counts, vals)

    def _append(self, verts: np.ndarray, counts: np.ndarray, vals: np.ndarray) -> None:
        row_lens = self.lens[verts].astype(np.int64)
        new_lens = row_lens + counts
        need = int(new_lens.max())
        if need > self.mat.shape[1] and self.mat.shape[1] < self.DEEP_CAP:
            cap = self.mat.shape[1]
            while cap < min(need, self.DEEP_CAP):
                cap *= 2
            if self.null is None:
                grown = np.empty((self.n, cap), dtype=np.int32)
            else:
                grown = np.full((self.n, cap), self.null, dtype=np.int32)
            grown[:, : self.mat.shape[1]] = self.mat
            self.mat = grown
        if need > self.DEEP_CAP:
            shallow = new_lens <= self.DEEP_CAP
            if not shallow.all():
                self._append_deep(verts, counts, vals, shallow)
                if not shallow.any():
                    return
                keep = np.repeat(shallow, counts)
                verts, counts, row_lens = verts[shallow], counts[shallow], row_lens[shallow]
                vals = vals[keep]
        if int(counts.max()) == 1:  # common case: one member labels each vertex
            self.mat[verts, row_lens] = vals
            self.lens[verts] += 1
            return
        total = int(counts.sum())
        v_rep = np.repeat(verts, counts)
        cum = np.cumsum(counts)
        within = np.arange(total, dtype=np.int64) - np.repeat(cum - counts, counts)
        self.mat[v_rep, np.repeat(row_lens, counts) + within] = vals
        self.lens[verts] += counts.astype(np.int32)

    def _append_deep(self, verts, counts, vals, shallow) -> None:
        """Slow path for rows crossing/beyond DEEP_CAP (a handful per build)."""
        offs = np.concatenate(([0], np.cumsum(counts)))
        for k in np.flatnonzero(~shallow):
            v = int(verts[k])
            row_vals = vals[offs[k] : offs[k + 1]].tolist()
            ln = int(self.lens[v])
            tail = self.deep.setdefault(v, [])
            room = self.DEEP_CAP - ln
            if room > 0:  # fill the dense head first
                self.mat[v, ln : self.DEEP_CAP] = row_vals[:room]
                row_vals = row_vals[room:]
            tail.extend(row_vals)
            self.lens[v] += counts[k]

    def rollback(self, verts: np.ndarray, new_lens: np.ndarray) -> None:
        """Truncate rows back to per-row watermarks (speculative undo).

        Rows are append-only, so rolling back a wave's writes is just
        restoring each touched row's length — stale values beyond the new
        length are never read.  Deep tails shrink (or vanish) to match."""
        old = self.lens[verts]
        self.lens[verts] = new_lens
        if self.null is not None:  # restore the tail-slot invariant
            width = self.mat.shape[1]
            lo = np.minimum(new_lens.astype(np.int64), width)
            hi = np.minimum(old.astype(np.int64), width)
            d = hi - lo
            shrunk = d > 0
            if shrunk.any():
                dd = d[shrunk]
                cum = np.cumsum(dd)
                cols = np.arange(int(cum[-1]), dtype=np.int64) - np.repeat(
                    cum - dd, dd) + np.repeat(lo[shrunk], dd)
                self.mat[np.repeat(verts[shrunk], dd), cols] = self.null
        if self.deep:
            for k in np.flatnonzero(old > self.DEEP_CAP):
                v = int(verts[k])
                tail = self.deep.get(v)
                if tail is None:
                    continue
                nl = int(new_lens[k])
                if nl > self.DEEP_CAP:
                    del tail[nl - self.DEEP_CAP :]
                else:
                    del self.deep[v]

    # -- checkpoint serialization ---------------------------------------

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Exact store state as named arrays (the checkpoint payload).

        The head matrix is saved at its CURRENT width: capacity growth is a
        deterministic function of the append sequence, so restoring the
        exact width keeps a resumed build on the identical growth path."""
        from repro_torch.persist.blocks import pack_ragged

        keys = np.fromiter(self.deep.keys(), dtype=np.int64, count=len(self.deep))
        vals, offs = pack_ragged([self.deep[int(k)] for k in keys])
        return {
            "store_mat": self.mat,
            "store_lens": self.lens,
            "store_deep_keys": keys,
            "store_deep_vals": vals,
            "store_deep_offs": offs,
        }

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray], meta: dict) -> "_LabelStore":
        """Rebuild a store from ``to_arrays`` output + the builder meta
        (``store_n`` / ``store_deep_cap`` / ``store_null``)."""
        from repro_torch.persist.blocks import unpack_ragged

        self = cls(int(meta["store_n"]), deep_cap=int(meta["store_deep_cap"]),
                   null=meta["store_null"])
        self.mat = np.ascontiguousarray(arrays["store_mat"], dtype=np.int32)
        self.lens = np.ascontiguousarray(arrays["store_lens"], dtype=np.int32)
        keys = arrays["store_deep_keys"]
        tails = unpack_ragged(arrays["store_deep_vals"], arrays["store_deep_offs"])
        self.deep = {int(k): list(t) for k, t in zip(keys, tails)}
        return self

    # -- reads ----------------------------------------------------------

    def row(self, v: int) -> np.ndarray:
        """Full label row of one vertex (deep tail included)."""
        ln = int(self.lens[v])
        head = self.mat[v, : min(ln, self.DEEP_CAP)]
        if ln <= self.DEEP_CAP:
            return head
        return np.concatenate([head, np.asarray(self.deep[v], dtype=np.int32)])

    def ragged_entries(self, verts: np.ndarray):
        """(values int32[t], lens int64[k]) — concatenated label entries of
        ``verts`` in order, deep tails included."""
        return self._timed("prune_gather", self._ragged_entries, verts)

    def _ragged_entries(self, verts: np.ndarray):
        lens = self.lens[verts].astype(np.int64)
        head_lens = np.minimum(lens, self.DEEP_CAP) if self.deep else lens
        total = int(head_lens.sum())
        cum = np.cumsum(head_lens)
        col = np.arange(total, dtype=np.int64) - np.repeat(cum - head_lens, head_lens)
        vals = self.mat[np.repeat(verts, head_lens), col]
        if self.deep and (lens > self.DEEP_CAP).any():
            parts: List[np.ndarray] = []
            prev = 0
            for k in np.flatnonzero(lens > self.DEEP_CAP):
                parts.append(vals[prev : int(cum[k])])
                parts.append(np.asarray(self.deep[int(verts[k])], dtype=np.int32))
                prev = int(cum[k])
            parts.append(vals[prev:])
            vals = np.concatenate(parts)
        return vals, lens

    def pruned_or(self, frontier: np.ndarray, hop_mask: np.ndarray) -> np.ndarray:
        """Member masks pruned[f] = OR_{h in L(frontier[f])} hop_mask[h].

        Single-word masks take a rectangular fast path — gather whole head
        rows, point tail columns at the hop table's always-zero last row,
        one flat take + one axis reduce, no ragged index arithmetic.  Wider
        masks gather raggedly so cost tracks actual label ints."""
        return self._timed("prune_gather", self._pruned_or, frontier, hop_mask)

    def _pruned_or(self, frontier: np.ndarray, hop_mask: np.ndarray) -> np.ndarray:
        lens = self.lens[frontier].astype(np.int64)
        out = np.zeros((frontier.shape[0], hop_mask.shape[1]), dtype=np.uint64)
        if frontier.shape[0] == 0:
            return out
        total = int(lens.sum())
        w = int(min(lens.max(initial=0), self.mat.shape[1]))
        # rect pays rows*w slots vs ragged's actual ints — worth it only while
        # the frontier's length skew is mild
        if hop_mask.shape[1] == 1 and w * frontier.shape[0] <= 4 * total:
            cols = np.arange(w, dtype=np.int64)[None, :]
            vals = self.mat[frontier[:, None], cols]  # narrow 2D gather
            if self.null is None:
                vals = np.where(
                    cols < lens[:, None], vals, np.int32(hop_mask.shape[0] - 1))
            out[:, 0] = np.bitwise_or.reduce(hop_mask[:, 0][vals], axis=1)
            if self.deep:
                for k in np.flatnonzero(lens > self.DEEP_CAP):  # rare deep rows
                    tail = np.asarray(self.deep[int(frontier[k])], dtype=np.int64)
                    out[k] |= np.bitwise_or.reduce(hop_mask[tail], axis=0)
            return out
        head_lens = np.minimum(lens, self.DEEP_CAP) if self.deep else lens
        total = int(head_lens.sum())
        if total:
            nz = head_lens > 0
            rows = frontier[nz]
            ln = head_lens[nz]
            cum = np.cumsum(ln)
            col = np.arange(int(cum[-1]), dtype=np.int64) - np.repeat(cum - ln, ln)
            hits = hop_mask[self.mat[np.repeat(rows, ln), col]]  # [t, K]
            out[nz] = np.bitwise_or.reduceat(hits, cum - ln, axis=0)
        if self.deep:
            for k in np.flatnonzero(lens > self.DEEP_CAP):  # rare deep rows
                tail = np.asarray(self.deep[int(frontier[k])], dtype=np.int64)
                out[k] |= np.bitwise_or.reduce(hop_mask[tail], axis=0)
        return out

    def pruned_any(self, frontier: np.ndarray, mark: np.ndarray) -> np.ndarray:
        """bool[f] — does any label of frontier[f] hit the bool[n+1] ``mark``
        table?  The single-member analogue of ``pruned_or`` (replay's prune
        test), same rectangular layout: tail slots index mark's always-False
        last entry."""
        return self._timed("prune_gather", self._pruned_any, frontier, mark)

    def _pruned_any(self, frontier: np.ndarray, mark: np.ndarray) -> np.ndarray:
        lens = self.lens[frontier].astype(np.int64)
        out = np.zeros(frontier.shape[0], dtype=bool)
        if frontier.shape[0] == 0:
            return out
        total = int(lens.sum())
        w = int(min(lens.max(initial=0), self.mat.shape[1]))
        if w * frontier.shape[0] <= 4 * total:  # same skew heuristic as pruned_or
            if w:
                cols = np.arange(w, dtype=np.int64)[None, :]
                vals = self.mat[frontier[:, None], cols]  # narrow 2D gather
                if self.null is None:
                    vals = np.where(
                        cols < lens[:, None], vals, np.int32(mark.shape[0] - 1))
                out = mark[vals].any(axis=1)
        else:
            head_lens = np.minimum(lens, self.DEEP_CAP) if self.deep else lens
            nz = head_lens > 0
            if nz.any():
                rows = frontier[nz]
                ln = head_lens[nz]
                cum = np.cumsum(ln)
                col = np.arange(int(cum[-1]), dtype=np.int64) - np.repeat(cum - ln, ln)
                hits = mark[self.mat[np.repeat(rows, ln), col]]
                out[nz] = np.logical_or.reduceat(hits, cum - ln)
        if self.deep:
            for k in np.flatnonzero(lens > self.DEEP_CAP):  # rare deep rows
                tail = np.asarray(self.deep[int(frontier[k])], dtype=np.int64)
                out[k] |= mark[tail].any()
        return out

    # -- finalize -------------------------------------------------------

    def finalize(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """Sort rows [start, stop) ascending, pack into the reference padding
        (multiple of 8, min 8, INVALID-padded) — byte-compatible with
        ``finalize_labels``.  The range lets one store hold both label sides
        (the fused sweep's role-split layout)."""
        return self._timed("finalize", self._finalize, start, stop)

    def _finalize(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        stop = self.n if stop is None else stop
        lens = self.lens[start:stop]
        mat = self.mat[start:stop]
        k = stop - start
        lmax = int(lens.max()) if k else 1
        width = max(
            ((max(lmax, 1) + _PAD_MULTIPLE - 1) // _PAD_MULTIPLE) * _PAD_MULTIPLE,
            _PAD_MULTIPLE,
        )
        out = np.full((k, width), INVALID, dtype=np.int32)
        # sort rows bucketed by length so short rows (the vast majority)
        # don't pay for the width a few deep rows force
        lo = 0
        b = _PAD_MULTIPLE
        cols = np.arange(width, dtype=np.int32)
        lens64 = lens.astype(np.int64)
        big = np.int32(self.n)  # sorts past every rank
        while lo < min(lmax, self.DEEP_CAP):
            sel = np.flatnonzero((lens64 > lo) & (lens64 <= min(b, self.DEEP_CAP)))
            if sel.size:
                w = min(b, self.DEEP_CAP)
                in_row = cols[None, :w] < lens64[sel, None]
                sub = np.where(in_row, mat[sel[:, None], cols[None, :w]], big)
                sub.sort(axis=1)
                out[sel[:, None], cols[None, :w]] = np.where(in_row, sub, INVALID)
            lo = b
            b *= 2
        for v in self.deep:  # rare deep rows, one by one
            if start <= v < stop:
                out[v - start, : lens64[v - start]] = np.sort(self.row(v))
        return out


# ---------------------------------------------------------------------------
# wave-granular build checkpointing
# ---------------------------------------------------------------------------


def _build_fingerprint(g: CSRGraph, order: np.ndarray, max_wave: int,
                       scheduler: str) -> str:
    """Identity of one build problem: a checkpoint resumes only a build of
    the SAME graph, rank order, and schedule parameters (schedules are
    deterministic in these, so the resumed run recomputes an identical
    schedule instead of persisting it)."""
    h = zlib.crc32(np.ascontiguousarray(g.indptr).tobytes())
    h = zlib.crc32(np.ascontiguousarray(g.indices).tobytes(), h)
    h = zlib.crc32(np.ascontiguousarray(order, dtype=np.int64).tobytes(), h)
    return f"{g.n}:{int(g.indices.shape[0])}:{max_wave}:{scheduler}:{h & 0xFFFFFFFF:08x}"


_CKPT_RE = re.compile(r"^ckpt_(\d{8})$")


class _BuildCheckpointer:
    """Wave/chunk-granular construction checkpoints.

    Each completed schedule boundary (exact wave, speculative chunk, or
    scalar-bailout chunk) bumps a monotone ``done`` counter; every
    ``every``-th boundary snapshots the exact ``_LabelStore`` state plus the
    cursor + adaptive-speculation state through ``persist.save_blocks``
    (checksummed, write-temp-then-rename — a crash mid-save leaves the
    previous checkpoint intact).  All scratch arrays are provably zero at
    boundaries, so store + cursor IS the complete builder state and a
    resumed build is byte-identical to an uninterrupted one."""

    def __init__(self, path: str, every: int = 16, keep: int = 2):
        self.path = path
        self.every = max(int(every), 1)
        self.keep = max(int(keep), 1)
        self.written = 0
        self.save_seconds = 0.0

    def maybe_save(self, done: int, store: _LabelStore, meta: dict) -> None:
        if done % self.every:
            return
        from repro_torch.persist.blocks import save_blocks

        meta = dict(meta, done=int(done),
                    store_n=store.n, store_deep_cap=store.DEEP_CAP,
                    store_null=store.null)
        sp = (trace.span("build.checkpoint", cat="build", args={"done": int(done)})
              if ON.enabled else trace.NOOP_SPAN)
        t0 = time.perf_counter()
        with sp:
            os.makedirs(self.path, exist_ok=True)
            save_blocks(os.path.join(self.path, f"ckpt_{done:08d}"),
                        store.to_arrays(), meta)
        self.save_seconds += time.perf_counter() - t0
        self.written += 1
        self._gc()

    def _gc(self) -> None:
        names = sorted(d for d in os.listdir(self.path) if _CKPT_RE.match(d))
        for stale in names[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, stale), ignore_errors=True)

    @staticmethod
    def latest(path: str, fingerprint: str):
        """Newest complete checkpoint matching ``fingerprint``, as
        ``(arrays, meta)`` — or None.  A corrupt or foreign checkpoint is
        skipped (with a warning) in favor of the next older one; a crash
        mid-save leaves only a ``.tmp`` which is never scanned."""
        from repro_torch.persist.blocks import CorruptSnapshotError, load_blocks

        if not os.path.isdir(path):
            return None
        for name in sorted(
                (d for d in os.listdir(path) if _CKPT_RE.match(d)), reverse=True):
            cpath = os.path.join(path, name)
            try:
                arrays, meta, _ = load_blocks(cpath, strict=True)
            except CorruptSnapshotError as e:
                warnings.warn(f"skipping unusable checkpoint {cpath}: {e}",
                              stacklevel=2)
                continue
            if meta.get("fingerprint") != fingerprint:
                warnings.warn(
                    f"skipping checkpoint {cpath}: fingerprint "
                    f"{meta.get('fingerprint')!r} does not match this build "
                    f"({fingerprint!r})", stacklevel=2)
                continue
            return arrays, meta
        return None


def _wave_sweep(
    members_c: np.ndarray,    # int64[2W] role-split ids: rev members + fwd (+n)
    ranks_c: np.ndarray,      # int32[2W] their global ranks (duplicated)
    hop_row_ids: np.ndarray,  # int64[2W] store rows feeding each BFS's prune test
    extra_hop_keys: np.ndarray,  # int64[W] wave ranks (fwd prune sets include v_j)
    store: _LabelStore,       # role-split labels: rows < n L_out, rows >= n L_in
    indptr: np.ndarray,       # combined CSR: rev graph rows then fwd (+n) rows
    indices: np.ndarray,
    hop_mask: np.ndarray,     # uint64[n + 1, K] scratch, zeros on entry/exit
    visited: np.ndarray,      # uint64[2n, K] scratch, zeros on entry/exit
) -> None:
    """Both directions of Algorithm 2 for a whole wave, fused: the reverse
    sweeps run in the [0, n) half of the role-split graph, the forward
    sweeps in [n, 2n), with disjoint member bits — one level loop drives up
    to 2 * max_wave pruned BFS at once."""
    w2 = members_c.shape[0]
    w = w2 // 2
    mbits = bitset.member_bits(w2, hop_mask.shape[1])  # uint64[2W, K]

    # hop_mask[h] = mask of member BFS whose prune set contains hop h: the
    # reverse BFS of v_j prunes on L_in(v_j) (store row n + v_j), the
    # forward BFS on L_out(v_j) ∪ {rank_j} (store row v_j + an extra key —
    # v_j itself joins L_out(v_j) during this very wave).  Hop keys live in
    # one rank space, but member bits are disjoint across roles, so a single
    # table serves both; foreign-role bits are masked off by fbits.  Members
    # may share hops (a common high-rank ancestor), so the scatter must OR.
    hop_vals, hop_lens = store.ragged_entries(hop_row_ids)
    hm_keys, hm_bits = bitset.group_or(
        np.concatenate([hop_vals, extra_hop_keys]),  # int32 + int64 upcasts
        np.concatenate([mbits[np.repeat(np.arange(w2), hop_lens)], mbits[w:]]),
    )
    hop_mask[hm_keys] = hm_bits

    visited[members_c] = mbits
    touched = [members_c]

    # level 0 specialization: every member labels itself (the self prune
    # test L_out(v) ∩ L_in(v) is empty in a DAG) and expands — skip the
    # generic prune/expand machinery for it
    store.append(members_c, np.ones(w2, dtype=np.int64), ranks_c)
    nbrs0, seg0 = bitset.csr_gather(indptr, indices, members_c)
    if nbrs0.size == 0:
        visited[members_c] = 0
        hop_mask[hm_keys] = 0
        return
    uniq0, obits0 = bitset.group_or(nbrs0, mbits[seg0])
    new0 = obits0 & ~visited[uniq0]
    keep0 = new0.any(axis=1)
    frontier = uniq0[keep0]
    fbits = new0[keep0]
    visited[frontier] |= fbits
    touched.append(frontier)

    while frontier.size:
        # prune test, whole frontier at once: OR the member masks of every
        # frontier vertex's current label entries.  Intra-wave appends can
        # appear in rows, but only the static wave-start verdict bits ever
        # intersect fbits (see waves.py for why).
        pruned = store.pruned_or(frontier, hop_mask)
        lab = fbits & ~pruned
        active = lab.any(axis=1)
        if not active.any():
            break
        v_lab = frontier[active]
        bits = lab[active]

        # label append: expand member masks to (vertex, member) pairs —
        # row-major, so values per row arrive member- (= rank-) ascending
        _, member, counts = bitset.expand_member_bits(bits, w2)
        store.append(v_lab, counts, ranks_c[member])

        # expansion: only labeled (un-pruned) vertices expand, carrying
        # exactly their labeled member bits
        nbrs, seg = bitset.csr_gather(indptr, indices, v_lab)
        if nbrs.size == 0:
            break
        uniq, obits = bitset.group_or(nbrs, bits[seg])  # indices already int64
        new = obits & ~visited[uniq]
        keep = new.any(axis=1)
        frontier = uniq[keep]
        fbits = new[keep]
        visited[frontier] |= fbits
        touched.append(frontier)

    # scratch cleanup (exactly the entries we wrote)
    visited[np.concatenate(touched)] = 0
    hop_mask[hm_keys] = 0


def _build_wave(
    g: CSRGraph,
    order: np.ndarray,
    max_wave: int = 256,
    waves: Optional[np.ndarray] = None,
    ckpt: Optional[_BuildCheckpointer] = None,
    fingerprint: Optional[str] = None,
    restored=None,
    stage_out: Optional[dict] = None,
) -> ReachabilityOracle:
    n = g.n
    if n == 0:
        return finalize_labels([], [], hop_rank=np.empty(0, dtype=np.int32))
    g_rev = g.reverse()
    if waves is None:
        waves = wave_schedule(g, order, max_wave=max_wave)
    ranks_of = np.arange(n, dtype=np.int32)

    # role-split layout: ids [0, n) run the reverse BFS over the reverse
    # graph and write L_out; ids [n, 2n) run the forward BFS over the
    # forward graph and write L_in.  One combined CSR + one label store let
    # a single level loop drive both directions of a wave.
    indptr = g.indptr.astype(np.int64)
    indices = g.indices.astype(np.int64)
    r_indptr = g_rev.indptr.astype(np.int64)
    r_indices = g_rev.indices.astype(np.int64)
    indptr_c = np.concatenate([r_indptr, r_indptr[-1] + indptr[1:]])
    indices_c = np.concatenate([r_indices, indices + n])

    k_words = bitset.n_words(2 * max_wave)
    # deep_cap=1024 keeps hub rows dense: on the dense-reachability families
    # hubs sit in most frontiers, and the per-row deep-dict loops would
    # otherwise run on every gather/append (max observed label length is a
    # few hundred, so the head matrix stays modest)
    store = _LabelStore(2 * n, deep_cap=1024, null=n)
    hop_mask = np.zeros((n + 1, k_words), dtype=np.uint64)
    visited = np.zeros((2 * n, k_words), dtype=np.uint64)

    start_wave, done = 0, 0
    if restored is not None:
        arrays, meta = restored
        store = _LabelStore.from_arrays(arrays, meta)
        start_wave = int(meta["wave_idx"])
        done = int(meta["done"])
    base = int(np.asarray(waves[:start_wave], dtype=np.int64).sum())
    for wi in range(start_wave, int(waves.shape[0])):
        wlen = int(waves[wi])
        inject.fire("build.wave", index=wi)
        members = order[base : base + wlen]
        ranks = ranks_of[base : base + wlen]
        members_c = np.concatenate([members, members + n])
        ranks_c = np.concatenate([ranks, ranks])
        # reverse BFS prunes on L_in rows (store n + v), forward on L_out
        # rows (store v) plus the member's own rank; narrow the scratch to
        # this wave's word width so short waves don't pay for max_wave
        hop_row_ids = np.concatenate([members + n, members])
        kwe = bitset.n_words(2 * wlen)
        sp = (trace.span("build.wave", cat="build",
                         args={"index": wi, "size": wlen})
              if ON.enabled else trace.NOOP_SPAN)
        with sp:
            _wave_sweep(
                members_c, ranks_c, hop_row_ids, ranks.astype(np.int64),
                store, indptr_c, indices_c, hop_mask[:, :kwe], visited[:, :kwe],
            )
        _WAVES_EXACT.inc()
        base += wlen
        done += 1
        if ckpt is not None:
            # all sweep scratch is zero again here: store + cursor is the
            # complete builder state
            ckpt.maybe_save(done, store, {
                "impl": "wave", "fingerprint": fingerprint, "wave_idx": wi + 1,
            })

    oracle = ReachabilityOracle(
        L_out=store.finalize(0, n),
        L_in=store.finalize(n, 2 * n),
        out_len=store.lens[:n].copy(),
        in_len=store.lens[n:].copy(),
        hop_rank=_hop_rank(order, n),
    )
    if stage_out is not None:
        stage_out.update(store.stage_seconds)
    return oracle


# ---------------------------------------------------------------------------
# speculative wave implementation (optimistic batching + certify + replay)
# ---------------------------------------------------------------------------


def _speculative_sweep(
    members_c: np.ndarray,    # int64[2W] role-split ids: rev members + fwd (+n)
    ranks_c: np.ndarray,      # int32[2W] their global ranks (duplicated)
    hop_row_ids: np.ndarray,  # int64[2W] store rows feeding each BFS's prune test
    extra_hop_keys: np.ndarray,  # int64[W] wave ranks (fwd prune sets include v_j)
    ranks: np.ndarray,        # int32[W] member-bit id -> global rank (both roles)
    half: np.ndarray,         # uint64[W, kr] one-hot member masks (bit j = member j)
    store: _LabelStore,
    indptr: np.ndarray,
    indices: np.ndarray,
    hop_rev: np.ndarray,      # uint64[n + 1, kr] scratch, zeros on entry
    hop_fwd: np.ndarray,      # uint64[n + 1, kr] scratch, zeros on entry
    visited: np.ndarray,      # uint64[2n, kr] scratch, zeros on entry
    labeled: np.ndarray,      # uint64[2n, kr] scratch, zeros on entry
):
    """The fused wave sweep of ``_wave_sweep``, run OPTIMISTICALLY: members
    are not proven mutually unreachable, so prune verdicts may be stale.

    Member bits use a SINGLE bank: bit j means member j in both sweep roles.
    That is unambiguous because the combined CSR keeps roles disjoint —
    rows < n only ever carry reverse-sweep bits and rows >= n forward-sweep
    bits — so the two roles need separate hop tables (``hop_rev`` feeding
    rows < n, ``hop_fwd`` rows >= n) but can share the narrowest possible
    word width, n_words(W), on every mask op.  Every append also accumulates
    into ``labeled`` and an append log (for rollback); the scratch is NOT
    cleared on exit — certification reads ``labeled`` first, then the caller
    cleans via the returned (touched, keys_rev, keys_fwd).

    Because wave-start prune sets are SUBSETS of the sequential ones, the
    sweep over-labels and over-visits relative to the sequential loop —
    which is exactly what makes the certification mask exact (bitset.
    violation_mask) and non-violated members exactly sequential.
    """
    w2 = members_c.shape[0]
    w = w2 // 2
    n = indptr.shape[0] // 2
    log: list = []

    hop_vals, hop_lens = store.ragged_entries(hop_row_ids)
    cut = int(hop_lens[:w].sum())
    jrep = np.arange(w)
    keys_rev, bits_rev = bitset.group_or(
        hop_vals[:cut], half[np.repeat(jrep, hop_lens[:w])])
    keys_fwd, bits_fwd = bitset.group_or(
        np.concatenate([hop_vals[cut:], extra_hop_keys]),
        np.concatenate([half[np.repeat(jrep, hop_lens[w:])], half]),
    )
    hop_rev[keys_rev] = bits_rev
    hop_fwd[keys_fwd] = bits_fwd

    mbits_c = np.concatenate([half, half])
    _seed_and_sweep(
        members_c, mbits_c, ranks_c, w, ranks, store, indptr, indices,
        hop_rev, hop_fwd, visited, labeled, log, touched := [])
    return np.concatenate(touched), keys_rev, keys_fwd, log


def _seed_and_sweep(
    seed_rows: np.ndarray,
    seed_bits: np.ndarray,
    seed_ranks: np.ndarray,
    w: int,
    ranks: np.ndarray,
    store: _LabelStore,
    indptr: np.ndarray,
    indices: np.ndarray,
    hop_rev: np.ndarray,
    hop_fwd: np.ndarray,
    visited: np.ndarray,
    labeled: np.ndarray,
    log: list,
    touched: list,
) -> None:
    """Seed the member rows (always labeled — a seed sharing a prune hop both
    ways would imply a cycle) and run the shared level loop of every
    optimistic sweep: whole-frontier prune gathers split by role at ``n``,
    append + log, frontier expansion under the visited masks."""
    n = indptr.shape[0] // 2
    visited[seed_rows] |= seed_bits
    labeled[seed_rows] |= seed_bits
    touched.append(seed_rows)
    ones = np.ones(seed_rows.shape[0], dtype=np.int64)
    store.append(seed_rows, ones, seed_ranks)
    log.append((seed_rows, ones, seed_ranks))
    nbrs0, seg0 = bitset.csr_gather(indptr, indices, seed_rows)
    if nbrs0.size == 0:
        return
    uniq0, obits0 = bitset.group_or(nbrs0, seed_bits[seg0])
    new0 = obits0 & ~visited[uniq0]
    keep0 = new0.any(axis=1)
    frontier = uniq0[keep0]
    fbits = new0[keep0]
    visited[frontier] |= fbits
    touched.append(frontier)

    while frontier.size:
        # frontier is sorted (group_or keys), so one searchsorted splits it
        # into the rev rows (< n, pruned against hop_rev) and the fwd rows
        cutf = int(np.searchsorted(frontier, n))
        pruned = np.empty((frontier.shape[0], fbits.shape[1]), dtype=np.uint64)
        pruned[:cutf] = store.pruned_or(frontier[:cutf], hop_rev)
        pruned[cutf:] = store.pruned_or(frontier[cutf:], hop_fwd)
        lab = fbits & ~pruned
        active = lab.any(axis=1)
        if not active.any():
            break
        v_lab = frontier[active]
        bits = lab[active]
        labeled[v_lab] |= bits

        _, member, counts = bitset.expand_member_bits(bits, w)
        vals = ranks[member]
        store.append(v_lab, counts, vals)
        log.append((v_lab, counts, vals))

        nbrs, seg = bitset.csr_gather(indptr, indices, v_lab)
        if nbrs.size == 0:
            break
        uniq, obits = bitset.group_or(nbrs, bits[seg])
        new = obits & ~visited[uniq]
        keep = new.any(axis=1)
        frontier = uniq[keep]
        fbits = new[keep]
        visited[frontier] |= fbits
        touched.append(frontier)


def _certify_chunk(
    members: np.ndarray,
    n: int,
    kr: int,
    labeled: np.ndarray,
    log: list,
) -> Optional[np.ndarray]:
    """Violation detection for one speculative chunk: None when every member
    certifies (the common case — and a cheap word-level quick-check when no
    member appended into a wave-mate's prune-source row at all), else the
    PER-SIDE pair (viol_rev bool[w], viol_fwd bool[w]) of sweeps needing
    correction — a member violated on one side keeps its other side's
    appends.

    The detector is EXACT given the sweep's over-approximation invariant
    (probes only ever prune on pre-chunk entries — mid-sweep appends carry
    other members' hop bits, never the prober's — so every sweep labels a
    superset of its sequential label set): member j's sweep truly diverges
    from the sequential loop iff it *labeled* a row u the sequential pass
    would have pruned, and that happens iff some lower-ranked mate i put
    its rank BOTH into j's prune-source row and into L(u) during the
    sweep.  Both conditions read the ``labeled`` scratch bits, which at
    certify time are exactly "which chunk ranks each row's label gained"
    (no chunk rank exists anywhere at chunk start).  An entry counted here
    may still be removed by the mate's own correction, so the error
    direction is over-flagging — sound, because the correction pass
    recomputes the exact surviving set per flagged side; rows j merely
    *visited* but was pruned at don't count, because the sequential pass
    prunes there too (its prune sets are supersets of the stale ones)."""
    w = members.shape[0]
    pref = bitset.prefix_bits(w, kr)
    own_rev = labeled[members, :kr]      # mates that entered L_out(v_j)
    own_fwd = labeled[n + members, :kr]  # mates that entered L_in(v_j)
    pf = own_fwd & pref  # lower-ranked candidates that stale-ed j's rev sweep
    pr = own_rev & pref  # lower-ranked candidates that stale-ed j's fwd sweep
    if not pf.any() and not pr.any():
        return None
    # which members' ranks each swept row's label gained, aggregated over
    # the rows each victim labeled.  Touch matrices mask the victim bits so
    # cost tracks candidate hits.
    rows = np.unique(np.concatenate([e[0] for e in log]))
    rrev = rows[rows < n]
    rfwd = rows[rows >= n]
    mb = bitset.member_bits(w, kr)
    jr = np.flatnonzero(pf.any(axis=1))
    jf = np.flatnonzero(pr.any(axis=1))
    zeros = np.zeros((w, kr), dtype=np.uint64)
    if jr.size:
        vm = np.bitwise_or.reduce(mb[jr], axis=0)
        lr = labeled[rrev, :kr]
        sel = np.flatnonzero((lr & vm).any(axis=1))
        t_rev = bitset.touch_matrix(lr[sel] & vm, lr[sel], w)
    else:
        t_rev = zeros
    if jf.size:
        vm = np.bitwise_or.reduce(mb[jf], axis=0)
        lf = labeled[rfwd, :kr]
        sel = np.flatnonzero((lf & vm).any(axis=1))
        t_fwd = bitset.touch_matrix(lf[sel] & vm, lf[sel], w)
    else:
        t_fwd = zeros
    viol_rev, viol_fwd = bitset.violation_mask(
        own_rev, own_fwd, t_rev, t_fwd, sides=True)
    if not viol_rev.any() and not viol_fwd.any():
        return None
    return viol_rev, viol_fwd


def _correct_chunk(
    store: _LabelStore,
    log: list,
    viol_rev: np.ndarray,
    viol_fwd: np.ndarray,
    members: np.ndarray,
    base: int,
    n: int,
    indptr: np.ndarray,
    indices: np.ndarray,
    mask: np.ndarray,
) -> None:
    """Exact rank-order correction of a violated chunk — no re-sweep.

    Because the speculative sweep over-approximates (each side labels a
    SUPERSET of its sequential label set) and certification is exact, the
    sequential result for a violated side is recoverable from the chunk log
    alone: it is the subset of the side's speculatively labeled rows still
    reachable from the seed once the rows the sequential pass would have
    *fresh-pruned* are removed.  A row u is fresh-pruned for member j's
    reverse sweep iff some surviving mate rank r < rank_j sits both in j's
    prune-source row (L_in(v_j) — mate r's forward append) and in L_out(u)
    (mate r's reverse append); both memberships are chunk appends, so they
    are read off the log, never the store.  The pruned-BFS connectivity is
    then a plain boolean BFS over the member's own labeled rows with the
    fresh-pruned rows blocked — no label gathers at all, which is what
    makes corrections an order of magnitude cheaper than re-running the
    pruned sweep.

    Violated sides are corrected in ascending rank order so each member's
    fresh keys and blocked sets are evaluated against the *surviving*
    (already corrected) appends of its lower-ranked mates — exactly the
    sequential store state at that member's turn.  The lowest violated
    member sees only certified mates, so the induction grounds out; one
    pass suffices, no re-certification.  Rolled-back entries are restored
    through per-row watermark truncation + one filtered stable re-append
    (rows only ever LOSE entries relative to the speculative run, and the
    finalize sorts row contents, so the surviving multiset is all that
    must match the sequential builder).

    ``mask`` is a caller-owned all-False bool[2n] scratch, returned
    all-False."""
    verts_cat = np.concatenate([e[0] for e in log])
    counts_cat = np.concatenate([e[1] for e in log]).astype(np.int64)
    vals_cat = np.concatenate([e[2] for e in log])
    v_rep = np.repeat(verts_cat, counts_cat)
    j_ent = vals_cat.astype(np.int64) - base  # chunk index of each entry
    keep = np.ones(v_rep.shape[0], dtype=bool)
    # entry indices sorted by row (fresh-key lookups) and by (member, side)
    o_row = np.argsort(v_rep, kind="stable")
    rows_sorted = v_rep[o_row]
    side_key = 2 * j_ent + (v_rep >= n)  # 2j = rev entries, 2j+1 = fwd
    o_ms = np.argsort(side_key, kind="stable")
    sk_sorted = side_key[o_ms]

    def ent_of(j: int, fwd: int) -> np.ndarray:
        lo, hi = np.searchsorted(sk_sorted, [2 * j + fwd, 2 * j + fwd + 1])
        return o_ms[lo:hi]

    surv: dict = {}  # (j, fwd) -> surviving rows of corrected sides

    def surviving(r: int, fwd: int) -> np.ndarray:
        got = surv.get((r, fwd))
        return got if got is not None else v_rep[ent_of(r, fwd)]

    for j in np.flatnonzero(viol_rev | viol_fwd):
        j = int(j)
        for fwd in (0, 1):
            if not (viol_fwd[j] if fwd else viol_rev[j]):
                continue
            seed = int(members[j]) + (n if fwd else 0)
            key_row = int(members[j]) + (0 if fwd else n)
            ent = ent_of(j, fwd)
            cand = v_rep[ent]  # j's labeled rows this side, seed included
            # fresh keys: surviving mate appends into the prune-source row
            lo, hi = np.searchsorted(rows_sorted, [key_row, key_row + 1])
            mask[cand] = True
            blocked = False
            for e in o_row[lo:hi]:
                r = int(j_ent[e])
                if r >= j or not keep[e]:
                    continue
                mask[surviving(r, fwd)] = False
                blocked = True
            if not blocked:  # over-flagged (keys all rolled back): no-op
                mask[cand] = False
                continue
            # a blocked seed would imply a cycle through a wave mate —
            # impossible in the condensation DAG, so the BFS always starts
            mask[seed] = False
            kept_parts = [np.asarray([seed], dtype=np.int64)]
            frontier = kept_parts[0]
            while frontier.size:
                nbrs, _ = bitset.csr_gather(indptr, indices, frontier)
                if nbrs.size == 0:
                    break
                nxt = np.unique(nbrs)
                nxt = nxt[mask[nxt]]
                if nxt.size == 0:
                    break
                mask[nxt] = False
                kept_parts.append(nxt)
                frontier = nxt
            mask[cand] = False  # reset blocked/unreached stragglers
            kept_rows = np.concatenate(kept_parts)
            surv[(j, fwd)] = kept_rows
            mask[kept_rows] = True
            keep[ent] = mask[cand]
            mask[kept_rows] = False

    # the store is only touched where an entry was actually removed: rows
    # losing nothing keep their speculative appends verbatim, so the
    # rollback-and-reappend rewrite cost tracks the violated members'
    # cones, not the whole chunk log
    removed = ~keep
    if not removed.any():  # pure over-flag: the chunk was already exact
        return
    af_rows = np.unique(v_rep[removed])
    mask[af_rows] = True
    sel = mask[v_rep]  # all log entries living in an affected row
    mask[af_rows] = False
    rows_a = v_rep[sel]
    u2, c2 = np.unique(rows_a, return_counts=True)  # u2 == af_rows
    if ON.enabled:
        trace.event("build.rollback", cat="build", rows=int(u2.shape[0]))
    store.rollback(u2, (store.lens[u2] - c2).astype(np.int32))
    # chaos hook: a crash between the watermark rollback and the surviving
    # re-append is the worst case for checkpoint resume — the store has
    # LOST the chunk's appends; resume must replay from the last boundary
    inject.fire("build.spec_replay", rows=int(u2.shape[0]))
    ksel = keep[sel]
    kv_rows, kv_vals = rows_a[ksel], vals_cat[sel][ksel]
    if kv_rows.size:
        o = np.argsort(kv_rows, kind="stable")
        rows_s, vals_s = kv_rows[o], kv_vals[o]
        u3, c3 = np.unique(rows_s, return_counts=True)
        store.append(u3, c3.astype(np.int64), vals_s)


def _scalar_replay(
    indptr: np.ndarray,
    indices: np.ndarray,
    seed: int,
    prune_row: int,
    rank: int,
    store: _LabelStore,
    prune_mark: np.ndarray,
) -> int:
    """One side of the sequential Algorithm-2 pass for one member, replayed
    against the live store.  The prune set is the member's prune-source row
    restricted to ranks BELOW its own — certified wave-mates with higher
    ranks have already appended 'future' entries that the sequential loop
    would not have seen yet, and the restriction is exactly what excludes
    them.  Replaying
    violated members in ascending rank order makes each replay see exactly
    the sequential store state, so one pass per member suffices (no
    re-speculation cascades on adversarial rank-consecutive chains)."""
    pvals = store.row(prune_row)
    pv = pvals[pvals < rank]
    prune_mark[pv] = True
    seen = np.zeros(indptr.shape[0] - 1, dtype=bool)
    seen[seed] = True
    frontier = np.asarray([seed], dtype=np.int64)
    out: List[np.ndarray] = []
    while frontier.size:
        # whole-level prune test: one rectangular gather of the frontier's
        # label rows against the marked prune ranks
        lab = frontier[~store.pruned_any(frontier, prune_mark)]
        if lab.size == 0:
            break
        out.append(lab)
        nbrs, _ = bitset.csr_gather(indptr, indices, lab)
        if nbrs.size == 0:
            break
        nbrs = np.unique(nbrs)
        frontier = nbrs[~seen[nbrs]]
        seen[frontier] = True
    prune_mark[pv] = False
    if out:
        rows = np.concatenate(out)
        store.append(
            rows, np.ones(rows.shape[0], dtype=np.int64),
            np.full(rows.shape[0], rank, dtype=np.int32),
        )
        return int(rows.shape[0])
    return 0


def _build_speculative(
    g: CSRGraph,
    order: np.ndarray,
    max_wave: int = 256,
    schedule=None,
    stats_out: Optional[dict] = None,
    ckpt: Optional[_BuildCheckpointer] = None,
    fingerprint: Optional[str] = None,
    restored=None,
    stage_out: Optional[dict] = None,
) -> ReachabilityOracle:
    """Speculative wave construction: optimistic chunks + certify + bounded
    rollback-replay.  Byte-identical to the scalar reference builder."""
    n = g.n
    if n == 0:
        return finalize_labels([], [], hop_rank=np.empty(0, dtype=np.int32))
    g_rev = g.reverse()
    if schedule is None:
        schedule = speculative_schedule(g, order, max_wave=max_wave)
    ranks_of = np.arange(n, dtype=np.int32)

    indptr = g.indptr.astype(np.int64)
    indices = g.indices.astype(np.int64)
    r_indptr = g_rev.indptr.astype(np.int64)
    r_indices = g_rev.indices.astype(np.int64)
    indptr_c = np.concatenate([r_indptr, r_indptr[-1] + indptr[1:]])
    indices_c = np.concatenate([r_indices, indices + n])

    # two scratch tiers: the exact fused sweep runs contiguous 2W bits at up
    # to n_words(2 * max_wave) words, while speculative chunks cap at
    # _SPEC_CAP members so every chunk mask is exactly ONE uint64 word —
    # dedicated contiguous single-word arrays keep the rectangular prune
    # gather and all level ops flat
    k_words = bitset.n_words(2 * max_wave)
    # deep_cap=1024 keeps hub rows dense: on the dense-reachability families
    # hubs sit in most frontiers, and the per-row deep-dict loops would
    # otherwise run on every gather/append (max observed label length is a
    # few hundred, so the head matrix stays modest)
    store = _LabelStore(2 * n, deep_cap=1024, null=n)
    hop_mask = np.zeros((n + 1, k_words), dtype=np.uint64)
    visited = np.zeros((2 * n, k_words), dtype=np.uint64)
    spec_cap = min(_SPEC_CAP, max_wave)
    hop_rev1 = np.zeros((n + 1, 1), dtype=np.uint64)
    hop_fwd1 = np.zeros((n + 1, 1), dtype=np.uint64)
    visited1 = np.zeros((2 * n, 1), dtype=np.uint64)
    labeled1 = np.zeros((2 * n, 1), dtype=np.uint64)
    prune_mark = np.zeros(n + 1, dtype=bool)  # trailing always-False fill slot
    corr_mask = np.zeros(2 * n, dtype=bool)  # _correct_chunk BFS scratch

    st = {
        "spec_waves": 0, "spec_members": 0, "clean_waves": 0, "violations": 0,
        "replayed_members": 0, "replayed_sides": 0, "exact_waves": 0,
        "annotated_pairs": 0, "certify_seconds": 0.0, "replay_seconds": 0.0,
        "scalar_bailout": False,
    }
    cap = spec_cap  # adaptive optimism: current speculative chunk size
    clean_streak = 0
    start_wave, start_off, done = 0, 0, 0
    if restored is not None:
        arrays, meta = restored
        store = _LabelStore.from_arrays(arrays, meta)
        start_wave = int(meta["wave_idx"])
        start_off = int(meta["off"])
        done = int(meta["done"])
        # the adaptive state decides every later chunk boundary — restoring
        # it keeps the resumed chunk sequence identical to an uninterrupted
        # run (byte-identity needs only store state, but stats/cadence
        # should not fork either)
        cap = int(meta["cap"])
        clean_streak = int(meta["clean_streak"])
        st.update(meta["st"])

    def _spec_chunk(base: int, w: int) -> None:
        nonlocal cap, clean_streak
        members = order[base : base + w]
        ranks = ranks_of[base : base + w]
        half = bitset.member_bits(w, 1)  # w <= _SPEC_CAP: one word always
        members_c = np.concatenate([members, members + n])
        ranks_c = np.concatenate([ranks, ranks])
        hop_row_ids = np.concatenate([members + n, members])
        touched, keys_rev, keys_fwd, log = _speculative_sweep(
            members_c, ranks_c, hop_row_ids, ranks.astype(np.int64),
            ranks, half, store, indptr_c, indices_c,
            hop_rev1, hop_fwd1, visited1, labeled1,
        )
        sp = (trace.span("build.certify", cat="build", args={"w": w})
              if ON.enabled else trace.NOOP_SPAN)
        t0 = time.perf_counter()
        with sp:
            viol = _certify_chunk(members, n, 1, labeled1, log)
        st["certify_seconds"] += time.perf_counter() - t0
        st["spec_waves"] += 1
        _WAVES_SPEC.inc()
        st["spec_members"] += w
        n_viol = 0
        if viol is not None:
            viol_rev, viol_fwd = viol
            either = viol_rev | viol_fwd
            n_viol = int(either.sum())
            st["violations"] += n_viol
            st["replayed_sides"] += int(viol_rev.sum()) + int(viol_fwd.sum())
            sp = (trace.span("build.replay", cat="build",
                             args={"violations": n_viol, "w": w})
                  if ON.enabled else trace.NOOP_SPAN)
            t0 = time.perf_counter()
            with sp:
                _correct_chunk(store, log, viol_rev, viol_fwd, members, base,
                               n, indptr_c, indices_c, corr_mask)
            st["replayed_members"] += n_viol
            st["replay_seconds"] += time.perf_counter() - t0
        visited1[touched] = 0
        labeled1[touched] = 0
        hop_rev1[keys_rev] = 0
        hop_fwd1[keys_fwd] = 0
        # bounded optimism: grow the chunk cap while rollbacks stay rare
        # (certification is exact, so a few violations per chunk cost only
        # their own replays), shrink it when they dominate
        rate = n_viol / w
        if n_viol == 0:
            st["clean_waves"] += 1
        if rate <= 0.05:
            clean_streak += 1
            if clean_streak >= 2:
                cap = min(cap * 2, spec_cap)
        else:
            clean_streak = 0
            if rate > 0.25:
                cap = max(cap // 2, 8)

    def _save(wi: int, off: int, wlen: int) -> None:
        # normalize the cursor so a resume never lands past a wave's end
        if off >= wlen:
            wi, off = wi + 1, 0
        ckpt.maybe_save(done, store, {
            "impl": "speculative", "fingerprint": fingerprint,
            "wave_idx": wi, "off": off,
            "cap": cap, "clean_streak": clean_streak, "st": dict(st),
        })

    base = int(np.asarray(schedule.lengths[:start_wave], dtype=np.int64).sum())
    n_sched = int(schedule.lengths.shape[0])
    for wi in range(start_wave, n_sched):
        wlen = int(schedule.lengths[wi])
        opt = bool(schedule.optimistic[wi])
        pr = schedule.pairs[wi]
        off = start_off if wi == start_wave else 0
        if not opt:
            # proven conflict-free: the exact fused sweep, no certification,
            # run at the wave's own word width
            inject.fire("build.wave", index=wi)
            members = order[base : base + wlen]
            ranks = ranks_of[base : base + wlen]
            members_c = np.concatenate([members, members + n])
            hop_row_ids = np.concatenate([members + n, members])
            kwe = bitset.n_words(2 * wlen)
            sp = (trace.span("build.wave", cat="build",
                             args={"index": wi, "size": wlen})
                  if ON.enabled else trace.NOOP_SPAN)
            with sp:
                _wave_sweep(
                    members_c, np.concatenate([ranks, ranks]), hop_row_ids,
                    ranks.astype(np.int64), store, indptr_c, indices_c,
                    hop_mask[:, :kwe], visited[:, :kwe],
                )
            st["exact_waves"] += 1
            _WAVES_EXACT.inc()
            done += 1
            if ckpt is not None:
                _save(wi, wlen, wlen)
        else:
            if off == 0 and isinstance(pr, np.ndarray):
                # a resumed wave (off > 0) already counted its pairs before
                # the checkpoint was taken
                st["annotated_pairs"] += int(pr.shape[0])
            while off < wlen:
                c = min(cap, wlen - off)
                inject.fire("build.chunk", index=done, wave=wi, off=off)
                # the chunk's lowest-ranked member can never be violated, so
                # the replay fraction is capped at (w - 1) / w = 0.875 at the
                # minimum cap of 8 — 0.85 sits just under that ceiling
                # (reachable by a true adversarial chain) and far above
                # healthy workloads
                if not st["scalar_bailout"] and (
                    st["spec_members"] >= 2048 and cap <= 8
                    and st["replayed_members"] > 0.85 * st["spec_members"]
                ):
                    st["scalar_bailout"] = True
                if st["scalar_bailout"]:
                    # worst case (adversarial chains): speculation keeps
                    # losing even at the minimum cap — degrade to the
                    # sequential scalar loop for the remaining optimistic
                    # ranks (chunk-wise, so the checkpoint cursor still
                    # covers it), bounding total work at ~reference cost
                    sp = (trace.span("build.chunk", cat="build",
                                     args={"wave": wi, "off": off, "size": c,
                                           "mode": "scalar_bailout"})
                          if ON.enabled else trace.NOOP_SPAN)
                    with sp:
                        for j in range(off, off + c):
                            v_j = int(order[base + j])
                            rank_j = base + j
                            _scalar_replay(indptr_c, indices_c, v_j, n + v_j,
                                           rank_j, store, prune_mark)
                            _scalar_replay(indptr_c, indices_c, n + v_j, v_j,
                                           rank_j, store, prune_mark)
                    _WAVES_BAILOUT.inc()
                else:
                    sp = (trace.span("build.chunk", cat="build",
                                     args={"wave": wi, "off": off, "size": c,
                                           "mode": "speculative"})
                          if ON.enabled else trace.NOOP_SPAN)
                    with sp:
                        _spec_chunk(base + off, c)
                off += c
                done += 1
                if ckpt is not None:
                    _save(wi, off, wlen)
        base += wlen

    if stats_out is not None:
        st["violation_rate"] = round(
            st["violations"] / max(st["spec_members"], 1), 4)
        st["certify_seconds"] = round(st["certify_seconds"], 4)
        st["replay_seconds"] = round(st["replay_seconds"], 4)
        stats_out.update(st)
    oracle = ReachabilityOracle(
        L_out=store.finalize(0, n),
        L_in=store.finalize(n, 2 * n),
        out_len=store.lens[:n].copy(),
        in_len=store.lens[n:].copy(),
        hop_rank=_hop_rank(order, n),
    )
    if stage_out is not None:
        stage_out.update(store.stage_seconds)
        stage_out["certify"] = st["certify_seconds"]
        stage_out["replay"] = st["replay_seconds"]
    return oracle

def sort_label_rows(mat: np.ndarray) -> np.ndarray:
    """Canonicalize INVALID-padded label rows: ascending values, pads last.

    The device builder's scatters append out of order."""
    big = np.iinfo(np.int32).max
    key = np.sort(np.where(mat == INVALID, big, mat), axis=1)
    return np.where(key == big, INVALID, key).astype(np.int32)
