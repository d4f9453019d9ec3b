"""Memory-budgeted serving tier: truncated rank-prefix labels under a hard
byte budget, with a live pressure-driven budget governor.

A copy of ``repro.serve.budget``: the cut stays numpy on the host; the
engine uploads the truncated store to its device in ``set_budget`` and its
``kernel`` backend decides the uncertain misses in K1's batch form
(``kernels.ops.ServeBatch`` with truncation masks).

The rank-ordered labels (§5.2 construction order; ``core.oracle``) have a
robustness property the serve stack never exploited: every row is sorted by
hop RANK, so the front of the row holds the hubs recorded by the most
labels and the tail holds the rare, highest-rank hops each recorded by
almost nothing.  A hard index-size budget can therefore be met by cutting
the highest-rank tail of every row — FERRARI-style (Seufert et al.,
arXiv 1211.3375: exact + truncated per-vertex entries under an index-size
restriction, online search as the escape hatch) — without ever risking a
wrong answer:

  * the cut is a single global **rank threshold** θ: an entry survives iff
    its rank value is < θ.  Rows are rank-sorted, so the cut is a per-vertex
    PREFIX — exactly the order §5.2 distributed the entries in, which means
    the truncated store is precisely the index a construction run stopped at
    rank θ would have produced;
  * verdicts become three-valued.  A hit on surviving prefixes is a proven
    YES (every surviving entry is a real label entry).  A miss is a proven
    NO unless BOTH rows were truncated: with a uniform threshold a kept
    entry (rank < θ) can never equal a dropped entry (rank >= θ), so the
    lost intersection lives entirely in dropped-x-dropped — it can only be
    non-empty when both sides dropped something.  The residue — miss with
    both rows cut — is UNCERTAIN and routes down the serve engine's
    existing degradation ladder to the exact bounded bidirectional search
    (``baselines.online_search.bidirectional_query``).  Wrong answers are
    impossible at any budget;
  * budgets are **monotone**: a smaller budget gives a smaller θ, kept
    prefixes shrink, and the per-query uncertain set only grows — so the
    uncertain rate is non-increasing in budget (gated in BENCH_serve).

``BudgetController`` is the live governor: it owns the retained full store
(or a ``persist`` snapshot path on memory-starved hosts), re-truncates IN
PLACE when a pressure signal crosses the watermark — a numpy prefix cut
over the retained store, never a rebuild — and steps the budget back up
with breaker-style hysteresis once pressure stays below the low watermark.
The serving daemon polls it between dispatch ticks, so a step never drops
an in-flight batch: batches capture their label view at entry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.ft import inject
from repro_torch.graph.csr import INVALID
from repro_torch.obs import metrics, trace
from repro_torch.obs.state import ON

_PAD_MULT = 8   # row padding multiple shared with finalize_labels

_M_BUDGET = metrics.gauge(
    "budget_bytes", "current label byte budget (0 = unbudgeted full store)")
_M_RESIDENT = metrics.gauge(
    "budget_resident_bytes", "resident truncated label bytes under the budget")
_M_STEPS = metrics.counter(
    "budget_pressure_steps_total", "pressure-driven budget steps, by direction",
    labelnames=("direction",))
_STEP_DOWN = _M_STEPS.labels(direction="down")
_STEP_UP = _M_STEPS.labels(direction="up")
_M_RETRUNC = metrics.counter(
    "budget_retruncations_total", "in-place re-truncations of the label store")


def label_bytes(oracle) -> int:
    """Resident bytes of the dense label matrices (what device memory pays)."""
    return int(oracle.L_out.nbytes + oracle.L_in.nbytes)


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """bool[n] -> packed uint8[ceil(n/8)] (the persisted mask layout)."""
    return np.packbits(np.asarray(mask, dtype=bool))


def unpack_mask(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of ``pack_mask``."""
    return np.unpackbits(np.asarray(packed, dtype=np.uint8), count=int(n)).astype(bool)


@dataclasses.dataclass(frozen=True)
class TruncatedStore:
    """An immutable rank-prefix truncation of a ReachabilityOracle.

    ``oracle`` is a real (smaller) ``ReachabilityOracle`` — same dense
    layout, same memoized device upload — whose rows are the rank-< θ
    prefixes of the full store's rows.  ``truncated_out/in`` mark the rows
    that lost entries; the serve engine's three-valued verdict logic reads
    them (see module docstring for why a miss needs BOTH marks to be
    uncertain).  ``budget_bytes`` is the budget the cut was derived from;
    ``resident_bytes`` what the truncated matrices actually occupy."""

    oracle: "object"            # ReachabilityOracle duck type
    truncated_out: np.ndarray   # bool[n] — L_out(v) lost entries
    truncated_in: np.ndarray    # bool[n]
    rank_cut: int               # θ: kept entries have rank value < θ
    budget_bytes: int
    resident_bytes: int
    dropped_ints: int           # label ints the cut removed

    @property
    def n(self) -> int:
        return int(self.oracle.n)

    @property
    def any_truncated(self) -> bool:
        return bool(self.truncated_out.any() or self.truncated_in.any())

    def packed_masks(self) -> tuple:
        """(packed_out, packed_in) uint8 bit masks — the persisted form."""
        return pack_mask(self.truncated_out), pack_mask(self.truncated_in)


def _snap(x: int) -> int:
    return max(((int(x) + _PAD_MULT - 1) // _PAD_MULT) * _PAD_MULT, _PAD_MULT)


def _cut_lens(mat: np.ndarray, lens: np.ndarray, theta: int) -> np.ndarray:
    """Per-row surviving-prefix length at rank threshold ``theta``.

    Rows hold their valid entries first (sorted ascending by rank value,
    INVALID = -1 padding after), so "count of entries < theta" IS the
    prefix length."""
    kept = ((mat != INVALID) & (mat < theta)).sum(axis=1).astype(np.int32)
    return np.minimum(kept, lens)


def _resident_at(oracle, theta: int) -> int:
    """Dense-layout bytes of the store truncated at ``theta``."""
    co = _cut_lens(oracle.L_out, oracle.out_len, theta)
    ci = _cut_lens(oracle.L_in, oracle.in_len, theta)
    wo = _snap(int(co.max()) if co.size else 0)
    wi = _snap(int(ci.max()) if ci.size else 0)
    return int(oracle.n * (wo + wi) * np.dtype(np.int32).itemsize)


def rank_cut_for_budget(oracle, budget_bytes: int) -> int:
    """Largest rank threshold θ whose truncated dense store fits the budget.

    Resident bytes are monotone non-decreasing in θ (prefixes only grow),
    so this is a binary search over θ in [0, n]; θ == n keeps everything.
    The floor θ = 0 empties every row — still exact (every non-structural
    verdict routes to the search rung), just slow: a budget too small for
    even one label column degrades to online search, it never lies."""
    n = int(oracle.n)
    budget_bytes = int(budget_bytes)
    if _resident_at(oracle, n) <= budget_bytes:
        return n
    lo, hi = 0, n          # invariant: resident(lo) <= budget < resident(hi)
    if _resident_at(oracle, 0) > budget_bytes:
        return 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _resident_at(oracle, mid) <= budget_bytes:
            lo = mid
        else:
            hi = mid
    return lo


def truncate_store(oracle, budget_bytes: Optional[int] = None,
                   rank_cut: Optional[int] = None) -> TruncatedStore:
    """Cut the highest-rank tail of every row to meet ``budget_bytes``
    (or an explicit ``rank_cut`` θ).  Pure numpy over the retained full
    store — this is the "re-truncate without a rebuild" primitive."""
    from repro_torch.core.oracle import ReachabilityOracle

    if rank_cut is None:
        if budget_bytes is None:
            raise ValueError("truncate_store needs budget_bytes or rank_cut")
        rank_cut = rank_cut_for_budget(oracle, budget_bytes)
    theta = int(rank_cut)

    def _side(mat, lens):
        cut = _cut_lens(mat, lens, theta)
        width = _snap(int(cut.max()) if cut.size else 0)
        new = mat[:, :width].copy()
        # kill everything past each row's surviving prefix
        cols = np.arange(width)[None, :]
        new[cols >= cut[:, None]] = INVALID
        return new, cut

    L_out, out_cut = _side(oracle.L_out, oracle.out_len)
    L_in, in_cut = _side(oracle.L_in, oracle.in_len)
    truncated = ReachabilityOracle(
        L_out=L_out, L_in=L_in, out_len=out_cut, in_len=in_cut,
        hop_rank=oracle.hop_rank,
    )
    dropped = int((oracle.out_len - out_cut).sum() + (oracle.in_len - in_cut).sum())
    return TruncatedStore(
        oracle=truncated,
        truncated_out=out_cut < oracle.out_len,
        truncated_in=in_cut < oracle.in_len,
        rank_cut=theta,
        budget_bytes=int(budget_bytes) if budget_bytes is not None
        else label_bytes(truncated),
        resident_bytes=label_bytes(truncated),
        dropped_ints=dropped,
    )


# ------------------------------------------------------------- controller


@dataclasses.dataclass
class PressureConfig:
    """Knobs for the live pressure loop (breaker-style hysteresis)."""

    watermark_bytes: int                  # step DOWN while signal > this
    low_watermark_frac: float = 0.7       # step UP once signal < frac * mark
    step_factor: float = 0.5              # each step multiplies the budget
    min_budget_bytes: int = 4096          # floor the governor never cuts past
    recovery_ticks: int = 3               # consecutive calm ticks before up
    check_interval_s: float = 0.05        # daemon poll period

    @property
    def low_watermark_bytes(self) -> int:
        return int(self.watermark_bytes * self.low_watermark_frac)


class BudgetController:
    """Live budget governor for one QueryEngine.

    Owns (a) the retained FULL oracle — or, on hosts too small to retain
    it, a ``persist`` snapshot path to reload from — and (b) the current
    byte budget.  ``apply`` re-truncates the retained store in place (a
    numpy prefix cut, never a rebuild) and swaps the result into the
    engine; ``tick`` runs the pressure state machine:

        signal > watermark          -> step the budget DOWN by step_factor
        signal < low watermark for  -> step the budget back UP (un-step),
        ``recovery_ticks`` ticks       all the way to the full store

    The hysteresis gap (watermark vs low watermark x recovery ticks) is the
    breaker idiom: a signal bouncing on the watermark cannot flap the store.
    ``pressure_source`` abstracts the signal — default is the engine's own
    resident label bytes, production wires an RSS/HBM probe, tests and the
    chaos driver inject a scripted source."""

    def __init__(
        self,
        engine,
        budget_bytes: Optional[int] = None,
        pressure: Optional[PressureConfig] = None,
        pressure_source: Optional[Callable[[], float]] = None,
        full_oracle=None,
        snapshot_path: Optional[str] = None,
        retain_full: bool = True,
    ):
        self.engine = engine
        self._full = full_oracle if full_oracle is not None else engine.oracle
        self.snapshot_path = snapshot_path
        if not retain_full:
            if snapshot_path is None:
                raise ValueError(
                    "retain_full=False needs snapshot_path: stepping the "
                    "budget back up must have a full store to cut from")
            self._full = None
        self.full_bytes = (label_bytes(self._full) if self._full is not None
                           else None)
        self.budget_bytes = None if budget_bytes is None else int(budget_bytes)
        self.pressure = pressure
        self.pressure_source = pressure_source
        self._calm_ticks = 0
        self._step_depth = 0       # how many pressure step-downs are active
        self._configured = self.budget_bytes   # the operator-set budget
        self.retruncations = 0
        self.steps_down = 0
        self.steps_up = 0
        if self.budget_bytes is not None:
            self.apply(self.budget_bytes)

    # ------------------------------------------------------------- store ops

    def full_oracle(self):
        """The full store: retained, or reloaded from the snapshot."""
        if self._full is None:
            from repro_torch.persist import load_oracle

            self._full = load_oracle(self.snapshot_path, strict=True)
            self.full_bytes = label_bytes(self._full)
        return self._full

    def resident_bytes(self) -> int:
        """Bytes the engine's served label matrices currently occupy."""
        store = getattr(self.engine, "budget_store", None)
        if store is not None:
            return store.resident_bytes
        return label_bytes(self.engine.oracle)

    def apply(self, budget_bytes: Optional[int]) -> Optional[TruncatedStore]:
        """Re-truncate to ``budget_bytes`` and swap the store into the
        engine (None = restore the full store).  In place: the cut runs
        over the retained full store, no label construction."""
        inject.fire("serve.retruncate", budget=budget_bytes)
        self.budget_bytes = None if budget_bytes is None else int(budget_bytes)
        if budget_bytes is None or (
                self.full_bytes is not None and budget_bytes >= self.full_bytes):
            self.engine.set_budget(None)
            _M_BUDGET.set(0)
            _M_RESIDENT.set(label_bytes(self.engine.oracle))
            return None
        sp = (trace.span("retruncate", cat="budget",
                         args={"budget_bytes": int(budget_bytes)})
              if ON.enabled else trace.NOOP_SPAN)
        with sp:
            store = truncate_store(self.full_oracle(), budget_bytes=budget_bytes)
            self.engine.set_budget(store)
        self.retruncations += 1
        _M_RETRUNC.inc()
        _M_BUDGET.set(int(budget_bytes))
        _M_RESIDENT.set(store.resident_bytes)
        return store

    def reapply(self) -> None:
        """Re-assert the current budget after an engine ``refresh`` dropped
        the store (new labels were published).  The refresh left the NEW
        full labels on ``engine.oracle`` — adopt them as the store to cut
        from; the old retained full store belongs to a dead epoch."""
        if self.budget_bytes is not None and getattr(
                self.engine, "budget_store", None) is None:
            if self._full is not None and self._full is not self.engine.oracle:
                self._full = self.engine.oracle
                self.full_bytes = label_bytes(self._full)
            self.apply(self.budget_bytes)

    # --------------------------------------------------------- pressure loop

    def signal(self) -> float:
        if self.pressure_source is not None:
            return float(self.pressure_source())
        return float(self.resident_bytes())

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One pressure-loop step; returns "step_down" / "step_up" / None.

        Down steps halve (``step_factor``) the currently-resident budget
        immediately; up steps wait for ``recovery_ticks`` consecutive ticks
        below the low watermark, then undo one step at a time, ending at
        the operator-configured budget (or the full store)."""
        if self.pressure is None:
            return None
        cfg = self.pressure
        sig = self.signal()
        if sig > cfg.watermark_bytes:
            self._calm_ticks = 0
            current = (self.budget_bytes if self.budget_bytes is not None
                       else self.full_bytes or self.resident_bytes())
            nxt = max(int(current * cfg.step_factor), cfg.min_budget_bytes)
            if nxt >= current:
                return None          # already at the floor
            self.apply(nxt)
            self._step_depth += 1
            self.steps_down += 1
            _STEP_DOWN.inc()
            if ON.enabled:
                trace.event("budget_step", cat="budget", direction="down",
                            budget_bytes=nxt, signal=int(sig))
            return "step_down"
        if sig < cfg.low_watermark_bytes and self._step_depth > 0:
            self._calm_ticks += 1
            if self._calm_ticks < cfg.recovery_ticks:
                return None
            self._calm_ticks = 0
            self._step_depth -= 1
            if self._step_depth == 0:
                nxt = self._configured
            else:
                assert self.budget_bytes is not None
                nxt = int(self.budget_bytes / cfg.step_factor)
                if self._configured is not None:
                    nxt = min(nxt, self._configured)
                if self.full_bytes is not None:
                    nxt = min(nxt, self.full_bytes)
            self.apply(nxt)
            self.steps_up += 1
            _STEP_UP.inc()
            if ON.enabled:
                trace.event("budget_step", cat="budget", direction="up",
                            budget_bytes=nxt, signal=int(sig))
            return "step_up"
        if sig >= cfg.low_watermark_bytes:
            self._calm_ticks = 0
        return None

    def snapshot(self) -> dict:
        """Health-endpoint view of the governor."""
        store = getattr(self.engine, "budget_store", None)
        return {
            "budget_bytes": self.budget_bytes,
            "configured_budget_bytes": self._configured,
            "full_bytes": self.full_bytes,
            "resident_bytes": self.resident_bytes(),
            "rank_cut": None if store is None else store.rank_cut,
            "truncated": store is not None and store.any_truncated,
            "step_depth": self._step_depth,
            "retruncations": self.retruncations,
            "steps_down": self.steps_down,
            "steps_up": self.steps_up,
        }
