"""Length-bucketed micro-batching for the serve path.

The dense/kernel backends pay O(La * Lb) compares per query at the *padded*
matrix width, so one hub-heavy row forces every short-label query in the
batch to Lmax^2 work. The planner buckets queries by their true need —
max(|L_out(u)|, |L_in(v)|) — into a small set of padded width tiers, so the
short majority runs at a fraction of the compare cost.

Shapes are kept to a small fixed set twice over:
  * tier widths are derived ONCE from the oracle's length distribution
    (quantiles snapped up to multiples of 8), not per batch;
  * tier row counts are padded up to power-of-two tiles (>= min_tile), so a
    varying query mix revisits a logarithmic set of batch shapes.  The
    verdicts match the JAX package's planner row for row.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

_PAD_WIDTH = 8


def _snap(x: int, multiple: int = _PAD_WIDTH) -> int:
    return max(((int(x) + multiple - 1) // multiple) * multiple, multiple)


def _pow2_at_least(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def tier_widths(
    out_len: np.ndarray,
    in_len: np.ndarray,
    full_width: int,
    n_tiers: int = 3,
    quantiles: Sequence[float] = (0.5, 0.9),
) -> List[int]:
    """Ascending padded label widths, last always covering ``full_width``.

    Boundaries come from quantiles of the pooled per-vertex label lengths —
    a static property of the oracle, so the tier set is stable across
    batches.
    """
    full = _snap(full_width)
    pooled = np.concatenate([out_len, in_len])
    pooled = pooled[pooled > 0]
    if pooled.size == 0:
        return [full]
    widths = sorted({_snap(q) for q in np.quantile(pooled, quantiles[: n_tiers - 1])})
    return [w for w in widths if w < full] + [full]


def tile_rows(count: int, min_tile: int) -> int:
    """Padded row count of a tier of ``count`` queries: the power-of-two
    tile at least ``min_tile``.  The one rule behind ``TierPlan.rows`` and
    the ``rows`` of every tier record in the engine's stats."""
    return _pow2_at_least(max(int(count), min_tile))


def tier_stats(counts: Sequence[int], widths: Sequence[int], min_tile: int) -> List[dict]:
    """The engine's per-batch tier records, ``{"width", "count", "rows"}`` for
    each non-empty tier, from the query count of every tier."""
    return [{"width": int(w), "count": int(c), "rows": tile_rows(c, min_tile)}
            for w, c in zip(widths, counts) if c]


@dataclasses.dataclass(frozen=True)
class TierPlan:
    idx: np.ndarray   # int32[k] positions into the original query batch
    width: int        # label columns this tier's intersection reads
    rows: int         # padded row count (power-of-two tile), rows >= k


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    tiers: List[TierPlan]
    n_queries: int

    @property
    def padded_rows(self) -> int:
        return sum(t.rows for t in self.tiers)

    def padded_queries(self, queries: np.ndarray, tier: TierPlan) -> np.ndarray:
        """Tier's query rows padded to its tile shape (pad rows gather vertex
        0 and are dropped at scatter time)."""
        q = queries[tier.idx]
        if tier.rows > q.shape[0]:
            pad = np.zeros((tier.rows - q.shape[0], 2), dtype=q.dtype)
            q = np.concatenate([q, pad], axis=0)
        return q

    def scatter(self, tier_results: Sequence[np.ndarray]) -> np.ndarray:
        """Reassemble per-tier results into batch order. Pad rows discarded."""
        out = np.zeros(self.n_queries, dtype=bool)
        for tier, res in zip(self.tiers, tier_results):
            out[tier.idx] = np.asarray(res)[: tier.idx.shape[0]]
        return out


def plan_batch(
    queries: np.ndarray,
    out_len: np.ndarray,
    in_len: np.ndarray,
    widths: Sequence[int],
    min_tile: int = 256,
) -> BatchPlan:
    """Assign each query to the narrowest tier that holds both its rows."""
    need = np.maximum(out_len[queries[:, 0]], in_len[queries[:, 1]])
    edges = np.asarray(widths, dtype=np.int64)
    tier_of = np.searchsorted(edges, need, side="left")
    tier_of = np.minimum(tier_of, len(widths) - 1)  # safety: clamp to widest
    tiers: List[TierPlan] = []
    for t, w in enumerate(widths):
        idx = np.nonzero(tier_of == t)[0].astype(np.int32)
        if idx.size == 0:
            continue
        tiers.append(TierPlan(idx=idx, width=int(w), rows=tile_rows(idx.size, min_tile)))
    return BatchPlan(tiers=tiers, n_queries=int(queries.shape[0]))
