"""Distribution-Labeling construction engine (paper §5, Algorithm 2).

The port's construction engine, held byte for byte against
``repro.build.engine``.  It carries two implementations:

``impl="reference"``
    The scalar path: per-vertex pruned BFS with python sets + deque (via
    ``traverse.pruned_bfs_distribute``), finalized into rank-space label
    matrices.

``impl="device"``
    The device wave engine (``engine_device.py``, the port of
    ``repro.build.engine_jax``): the wave schedule of ``waves.wave_schedule``
    with each wave's sweeps on the build's ``device`` — through the
    hand-written K2 kernel on a card, its plain version on the CPU.

Their labels are byte-identical to every implementation of the JAX package
(``reference``, ``wave``, ``speculative``, ``device``), the contract those
engines keep among themselves, so building with the port changes no verdict.

``impl="auto"`` mirrors the JAX engine's routing: "reference" below 4096
vertices; on a dense-reachability graph, or when the exact schedule aborts
or its mean wave is short, JAX picks its ``speculative`` engine, which is
not ported yet, so the port resolves to "reference" there
(``build_stats["auto_wanted"]`` says so); otherwise "device" on the build's
device.  The host batched engines (``wave``, ``speculative``) raise
``NotImplementedError`` naming their ROADMAP.md item.

Every oracle built here carries the same ``build_stats`` breadcrumb as the
JAX engine's: ``{"impl", "scheduler", "schedule_seconds", "sweep_seconds",
"n_waves", "stages", "stage_shares"}``, plus a ``"device"`` sub-dict of
sweep, BFS-level, host-read and regrow counts when the device engine ran.
"""
from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np

from repro_torch.build.traverse import pruned_bfs_distribute
from repro_torch.build.waves import wave_schedule
from repro_torch.core.oracle import ReachabilityOracle, finalize_labels
from repro_torch.core.order import get_order
from repro_torch.graph.csr import CSRGraph, INVALID
from repro_torch.obs import metrics, trace
from repro_torch.obs.state import ON

_NOT_PORTED = {
    "wave": "ROADMAP.md Queue 1 item 3 (host wave engine)",
    "bitset": "ROADMAP.md Queue 1 item 3 (host wave engine)",
    "speculative": "ROADMAP.md Queue 1 item 3 (host speculative engine)",
}
# below this vertex count the scalar reference path wins
_AUTO_WAVE_MIN = 4096
# impl="auto" leaves the wave engines when the schedule's mean wave is
# smaller than this — per-wave overhead would dominate
_AUTO_MIN_AVG_WAVE = 24.0
# impl="auto" treats a graph as dense-reachability when the sampled mean
# forward cone covers at least this fraction of it
_AUTO_DENSE_REACH = 0.02
# the device engine's tuning knobs; any other extra kwarg is a TypeError
_DEVICE_KWARGS = frozenset({"l_max", "ell_width", "prune_cap"})

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
    waves: Optional[np.ndarray] = None,
    device="cuda",
    **device_kwargs,
) -> ReachabilityOracle:
    """Build the DL oracle for DAG ``g`` with the selected implementation.

    ``device`` is where the device engine runs (``"cuda"`` by default; it
    raises ``RuntimeError`` without a card); the reference engine runs on
    the host whatever it says.  ``waves`` hands the device engine a
    schedule instead of computing one.  ``device_kwargs`` (``l_max=``,
    ``ell_width=``, ``prune_cap=``) go to the device engine; any other
    name, or any of them with a host impl, is a ``TypeError`` — a typo'd
    tuning knob must not silently no-op — and ``mesh=`` raises
    ``NotImplementedError`` (ROADMAP.md Queue 1 item 11).
    """
    if impl in _NOT_PORTED:
        raise NotImplementedError(
            f"construction impl {impl!r} is not ported yet: {_NOT_PORTED[impl]}")
    if impl not in ("auto", "reference", "ref", "device"):
        raise ValueError(f"unknown construction impl {impl!r}")
    if "mesh" in device_kwargs:
        raise NotImplementedError(
            "the sharded device expansion (mesh=) is not ported yet: "
            "ROADMAP.md Queue 1 item 11 (multi-device modes)")
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
    t_sched = 0.0
    auto_wanted = None
    if impl == "auto":
        if g.n < _AUTO_WAVE_MIN:
            impl = "reference"
        elif _sampled_reach_density(g) >= _AUTO_DENSE_REACH:
            impl, auto_wanted = "reference", "speculative"
        else:
            # the exact schedule is the profitability probe: tiny mean waves
            # cannot amortize the batched sweeps
            t0 = time.perf_counter()
            probe = wave_schedule(
                g, order, max_wave=max_wave, scheduler=scheduler,
                abort_below_avg=_AUTO_MIN_AVG_WAVE / 3,
            )
            t_sched = time.perf_counter() - t0
            if probe is None or g.n / probe.shape[0] < _AUTO_MIN_AVG_WAVE:
                impl, auto_wanted = "reference", "speculative"
            else:
                impl = "device"
                if waves is None:
                    waves = probe
    if impl in ("ref", "reference"):
        impl = "reference"
        if device_kwargs or waves is not None:
            # auto resolved to the host reference: the knobs do not apply
            warnings.warn(
                f"device-engine kwargs {sorted(device_kwargs)} ignored: impl "
                "resolved to 'reference'", stacklevel=2)
            waves = None
    if impl == "device" and waves is None:
        t0 = time.perf_counter()
        waves = wave_schedule(g, order, max_wave=max_wave, scheduler=scheduler)
        t_sched += time.perf_counter() - t0
    device_stats: dict = {}
    sweep_sp = (trace.span("build.sweep", cat="build",
                           args={"impl": impl, "n": g.n})
                if ON.enabled else trace.NOOP_SPAN)
    t0 = time.perf_counter()
    with sweep_sp:
        if impl == "reference":
            oracle = _build_reference(g, order)
        else:
            from repro_torch.build.engine_device import distribution_labeling_device

            oracle = distribution_labeling_device(
                g, order=order, waves=waves, device=device,
                stats_out=device_stats, **device_kwargs)
    t_sweep = time.perf_counter() - t0
    object.__setattr__(oracle, "build_impl", impl)
    stages = {"schedule": t_sched, "sweep": t_sweep}
    total = t_sched + t_sweep
    stats = {
        "impl": impl,
        "scheduler": scheduler if waves is not None else None,
        "schedule_seconds": round(t_sched, 4),
        "sweep_seconds": round(t_sweep, 4),
        "n_waves": None if waves is None else int(waves.shape[0]),
        "stages": {k: round(float(v), 4) for k, v in sorted(stages.items())},
        "stage_shares": {
            k: (round(float(v) / total, 4) if total > 0 else 0.0)
            for k, v in sorted(stages.items())
        },
    }
    if auto_wanted is not None:
        stats["auto_wanted"] = auto_wanted
    if device_stats:
        stats["device"] = device_stats
    for k, v in stages.items():
        _M_STAGE_SECONDS.labels(stage=k).inc(float(v))
    object.__setattr__(oracle, "build_stats", stats)
    return oracle


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


def _hop_rank(order: np.ndarray, n: int) -> np.ndarray:
    """rank[order[i]] = i — the rank-space remap shared by all impls."""
    hop_rank = np.empty(n, dtype=np.int32)
    hop_rank[order] = np.arange(n, dtype=np.int32)
    return hop_rank


def sort_label_rows(mat: np.ndarray) -> np.ndarray:
    """Canonicalize INVALID-padded label rows: ascending values, pads last.

    The device builder's scatters append out of order."""
    big = np.iinfo(np.int32).max
    key = np.sort(np.where(mat == INVALID, big, mat), axis=1)
    return np.where(key == big, INVALID, key).astype(np.int32)
