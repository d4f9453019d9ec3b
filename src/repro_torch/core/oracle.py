"""ReachabilityOracle: the hop-labeling container + query paths.

u reaches v  iff  L_out(u) `intersect` L_in(v) != empty.

Labels are finalized into dense padded int32 matrices [n, L_max] (rows sorted
ascending, INVALID = -1 padding) — the device/serving layout. The host keeps
per-row lengths for exact-size accounting (paper's index-size metric counts
total integers, Figures 3/4).

Rank-ordered labels: when a construction order is available (DL's §5.2 rank),
``finalize_labels`` remaps every hop id to its *position in the processing
order*. The remap is a bijection, so intersection emptiness is unchanged, but
rows sorted ascending are now simultaneously value-sorted (searchsorted merge
still works) and rank-ordered: the highest-ranked hop — the one recorded by
the most labels — sits at the front of every row, so intersections terminate
early on positive queries (hierarchical-hub-labeling style early exit).
``hop_rank`` keeps the vertex->rank map; ``unrank`` recovers vertex ids.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.csr import INVALID

# length of the high-rank prefix probed before the full merge in host queries
_PREFIX = 8
# row padding multiple shared with finalize_labels / the build engine
_PAD_MULT = 8


@dataclasses.dataclass(frozen=True)
class ReachabilityOracle:
    L_out: np.ndarray  # int32[n, Lo_max], sorted rows, INVALID padded
    L_in: np.ndarray   # int32[n, Li_max]
    out_len: np.ndarray  # int32[n]
    in_len: np.ndarray   # int32[n]
    # vertex -> rank when labels live in rank space (None = vertex-id space)
    hop_rank: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return int(self.L_out.shape[0])

    @property
    def total_label_size(self) -> int:
        """Paper's index-size metric: sum(|L_out| + |L_in|) in integers."""
        return int(self.out_len.sum() + self.in_len.sum())

    @property
    def max_label_len(self) -> int:
        return int(max(self.L_out.shape[1], self.L_in.shape[1]))

    def unrank(self, hops: np.ndarray) -> np.ndarray:
        """Map label values back to vertex ids (identity in vertex-id space)."""
        if self.hop_rank is None:
            return np.asarray(hops)
        inv = getattr(self, "_inv_rank", None)
        if inv is None:  # memoize: inv[rank] = vertex
            inv = np.argsort(self.hop_rank).astype(np.int32)
            object.__setattr__(self, "_inv_rank", inv)
        return inv[np.asarray(hops)]

    # ---------------- row hooks (dynamic-oracle seam) ----------------

    def row_out(self, v: int) -> np.ndarray:
        """L_out(v) without padding (sorted ascending, rank space)."""
        return self.L_out[v, : self.out_len[v]]

    def row_in(self, v: int) -> np.ndarray:
        """L_in(v) without padding (sorted ascending, rank space)."""
        return self.L_in[v, : self.in_len[v]]

    def with_updated_rows(
        self,
        out_rows: "dict[int, Sequence[int]]",
        in_rows: "dict[int, Sequence[int]]",
    ) -> "ReachabilityOracle":
        """Copy-on-write row replacement: the append/invalidate hook used by
        ``repro_torch.dynamic`` to publish repaired labels as a new immutable
        snapshot.  Each dict maps vertex -> full replacement row (sorted
        ascending, rank space, no padding; may be longer or shorter than the
        current row — matrices grow in the same multiple-of-8 padding as
        ``finalize_labels``).  The result is byte-identical to re-finalizing
        the mutated label lists.  A side with no updates shares the base
        matrix outright (snapshots are immutable); a side with updates is
        copied before writing, so publish cost tracks the dirtied side's
        matrix, not both."""

        def _cow(mat: np.ndarray, lens: np.ndarray, updates):
            if not updates:
                return mat, lens
            lens = lens.copy()
            need = int(max((len(r) for r in updates.values()), default=0))
            width = mat.shape[1]
            if need > width:
                width = max(
                    ((need + _PAD_MULT - 1) // _PAD_MULT) * _PAD_MULT, _PAD_MULT
                )
            grown = np.full((mat.shape[0], width), INVALID, dtype=np.int32)
            grown[:, : mat.shape[1]] = mat
            for v, row in updates.items():
                ln = len(row)
                grown[v, :ln] = np.asarray(row, dtype=np.int32)
                grown[v, ln : max(int(lens[v]), ln)] = INVALID
                lens[v] = ln
            return grown, lens

        L_out, out_len = _cow(self.L_out, self.out_len, out_rows)
        L_in, in_len = _cow(self.L_in, self.in_len, in_rows)
        return ReachabilityOracle(
            L_out=L_out, L_in=L_in, out_len=out_len, in_len=in_len,
            hop_rank=self.hop_rank,
        )

    # ---------------- host query paths ----------------

    def query(self, u: int, v: int) -> bool:
        """Single query: vectorized sorted intersection (searchsorted), with a
        high-rank prefix probe first — in rank space the frequent hops sort to
        the front, so most positive queries resolve in the prefix."""
        a = self.L_out[u, : self.out_len[u]]
        b = self.L_in[v, : self.in_len[v]]
        na, nb = a.shape[0], b.shape[0]
        if na == 0 or nb == 0:
            return False
        if a[0] == b[0]:
            return True
        if na > _PREFIX and nb > _PREFIX:
            pa, pb = a[:_PREFIX], b[:_PREFIX]
            pos = np.searchsorted(pa, pb)
            if (pa[np.minimum(pos, _PREFIX - 1)] == pb).any():
                return True
        pos = np.searchsorted(a, b)
        return bool((a[np.minimum(pos, na - 1)] == b).any())

    def query_batch_np(self, queries: np.ndarray) -> np.ndarray:
        """Vectorized all-pairs-compare batch query (numpy mirror of the
        device path). queries: int32[B, 2] -> bool[B]."""
        a = self.L_out[queries[:, 0]]  # [B, Lo]
        b = self.L_in[queries[:, 1]]   # [B, Li]
        eq = a[:, :, None] == b[:, None, :]
        valid = (a[:, :, None] != INVALID) & (b[:, None, :] != INVALID)
        return (eq & valid).any(axis=(1, 2))

    # ---------------- device arrays ----------------

    def device_labels(self, device):
        """int32 torch copies of the label matrices on ``device``, memoized
        per snapshot and per device.

        Snapshots are immutable, so the first upload to a device is cached
        on the instance and every engine serving this snapshot on that
        device reads the SAME tensors.  The cache is keyed by the resolved
        device (``repro_torch.device.resolve_device``), so a CPU engine and
        a CUDA engine over one oracle each get their own copy."""
        dev = resolve_device(device)
        cache = getattr(self, "_device_labels", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_device_labels", cache)
        pair = cache.get(dev)
        if pair is None:
            pair = (torch.from_numpy(np.ascontiguousarray(self.L_out, dtype=np.int32)).to(dev),
                    torch.from_numpy(np.ascontiguousarray(self.L_in, dtype=np.int32)).to(dev))
            cache[dev] = pair
        return pair


def oracle_from_arrays(
    L_out: np.ndarray,
    L_in: np.ndarray,
    out_len: np.ndarray,
    in_len: np.ndarray,
    hop_rank: Optional[np.ndarray] = None,
) -> ReachabilityOracle:
    """The port's oracle over label arrays built elsewhere (weights carried
    across): pass the numpy fields of a ``repro`` ``ReachabilityOracle`` and
    the port serves the very same labels.  Arrays are copied, so the result
    shares no buffer with the source."""
    L_out = np.array(L_out, dtype=np.int32, order="C")
    L_in = np.array(L_in, dtype=np.int32, order="C")
    out_len = np.array(out_len, dtype=np.int32)
    in_len = np.array(in_len, dtype=np.int32)
    if L_out.ndim != 2 or L_in.ndim != 2 or L_out.shape[0] != L_in.shape[0]:
        raise ValueError(f"label matrices disagree: {L_out.shape} vs {L_in.shape}")
    n = L_out.shape[0]
    if out_len.shape != (n,) or in_len.shape != (n,):
        raise ValueError(f"length vectors must be int[{n}]")
    if hop_rank is not None:
        hop_rank = np.array(hop_rank, dtype=np.int32)
        if hop_rank.shape != (n,):
            raise ValueError(f"hop_rank must be int[{n}]")
    return ReachabilityOracle(L_out=L_out, L_in=L_in, out_len=out_len,
                              in_len=in_len, hop_rank=hop_rank)


def finalize_labels(
    out_lists: Sequence[Sequence[int]],
    in_lists: Sequence[Sequence[int]],
    pad_to_multiple: int = 8,
    hop_rank: Optional[np.ndarray] = None,
) -> ReachabilityOracle:
    """Pack per-vertex python label lists into the dense oracle layout.

    With ``hop_rank`` (int32[n], rank[v] = position of v in the construction
    order, 0 = highest), hop ids are remapped to rank space before the
    ascending row sort — see module docstring.
    """
    n = len(out_lists)
    out_len = np.array([len(x) for x in out_lists], dtype=np.int32)
    in_len = np.array([len(x) for x in in_lists], dtype=np.int32)

    def _pack(lists: Sequence[Sequence[int]], lens: np.ndarray) -> np.ndarray:
        lmax = int(lens.max()) if n else 1
        lmax = max(((lmax + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple, pad_to_multiple)
        mat = np.full((n, lmax), INVALID, dtype=np.int32)
        for i, row in enumerate(lists):
            if len(row):  # rows may be python lists OR numpy arrays
                vals = np.asarray(row, dtype=np.int32)
                if hop_rank is not None:
                    vals = hop_rank[vals]
                mat[i, : len(row)] = np.sort(vals)
        return mat

    return ReachabilityOracle(
        L_out=_pack(out_lists, out_len),
        L_in=_pack(in_lists, in_len),
        out_len=out_len,
        in_len=in_len,
        hop_rank=None if hop_rank is None else np.asarray(hop_rank, dtype=np.int32),
    )


def merge_hop_lists(parts: List[np.ndarray]) -> np.ndarray:
    """Sorted-unique union of hop id arrays (HL's label merge)."""
    if not parts:
        return np.empty(0, dtype=np.int32)
    cat = np.concatenate([np.asarray(p, dtype=np.int32) for p in parts])
    return np.unique(cat[cat != INVALID])
