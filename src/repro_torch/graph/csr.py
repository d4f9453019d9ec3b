"""CSR graph container (host numpy) + padded ELL view for device kernels.

All construction algorithms operate on int32 CSR. Edges are stored sorted by
source (CSR) and can be re-materialized sorted by destination (CSC of the
reverse graph) for segment-sum style scatter on device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np

INVALID = np.int32(-1)


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Immutable CSR directed graph.

    indptr:  int32[n+1]
    indices: int32[m]   -- out-neighbors of vertex i are indices[indptr[i]:indptr[i+1]]
    """

    indptr: np.ndarray
    indices: np.ndarray

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def m(self) -> int:
        return int(self.indices.shape[0])

    def out_neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def reverse(self) -> "CSRGraph":
        """CSR of the reverse graph (in-neighbors become out-neighbors)."""
        n, m = self.n, self.m
        src = np.repeat(np.arange(n, dtype=np.int32), np.diff(self.indptr))
        dst = self.indices
        order = np.argsort(dst, kind="stable")
        r_indices = src[order]
        counts = np.bincount(dst, minlength=n).astype(np.int64)
        r_indptr = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(counts, out=r_indptr[1:])
        return CSRGraph(r_indptr.astype(np.int32), r_indices.astype(np.int32))

    def in_degree(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.n).astype(np.int32)

    def edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) int32 arrays of all edges."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), np.diff(self.indptr))
        return src, self.indices.copy()

    def to_ell(self, max_deg: int | None = None) -> "ELLGraph":
        """Padded neighbor-list view: int32[n, max_deg] with INVALID padding."""
        deg = self.out_degree()
        md = int(deg.max()) if max_deg is None else int(max_deg)
        md = max(md, 1)
        nbr = np.full((self.n, md), INVALID, dtype=np.int32)
        for v in range(self.n):
            row = self.out_neighbors(v)[:md]
            nbr[v, : row.shape[0]] = row
        return ELLGraph(neighbors=nbr, degrees=np.minimum(deg, md).astype(np.int32))

    def subgraph(self, keep: np.ndarray) -> Tuple["CSRGraph", np.ndarray]:
        """Induced subgraph over `keep` (bool[n] or index array).

        Returns (subgraph, old_ids) where old_ids[i] is the original id of
        new vertex i.
        """
        if keep.dtype == np.bool_:
            old_ids = np.nonzero(keep)[0].astype(np.int32)
        else:
            old_ids = np.asarray(keep, dtype=np.int32)
        remap = np.full(self.n, INVALID, dtype=np.int32)
        remap[old_ids] = np.arange(old_ids.shape[0], dtype=np.int32)
        src, dst = self.edges()
        mask = (remap[src] != INVALID) & (remap[dst] != INVALID)
        return (
            from_edges(old_ids.shape[0], remap[src[mask]], remap[dst[mask]]),
            old_ids,
        )


@dataclasses.dataclass(frozen=True)
class ELLGraph:
    """Padded fixed-width neighbor lists (device-friendly).

    neighbors: int32[n, max_deg], INVALID-padded
    degrees:   int32[n]
    """

    neighbors: np.ndarray
    degrees: np.ndarray

    @property
    def n(self) -> int:
        return int(self.neighbors.shape[0])

    @property
    def max_deg(self) -> int:
        return int(self.neighbors.shape[1])


def from_edges(n: int, src: Iterable[int], dst: Iterable[int], dedup: bool = True) -> CSRGraph:
    """Build CSR from edge lists. Self-loops removed; duplicates optionally removed."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if dedup and src.shape[0] > 0:
        key = src * np.int64(n) + dst
        _, uidx = np.unique(key, return_index=True)
        src, dst = src[uidx], dst[uidx]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr.astype(np.int32), dst.astype(np.int32))


def is_dag(g: CSRGraph) -> bool:
    """Kahn's algorithm: true iff g is acyclic."""
    indeg = g.in_degree().astype(np.int64)
    stack = list(np.nonzero(indeg == 0)[0])
    seen = 0
    while stack:
        v = stack.pop()
        seen += 1
        for w in g.out_neighbors(v):
            indeg[w] -= 1
            if indeg[w] == 0:
                stack.append(int(w))
    return seen == g.n


def topo_levels(g: CSRGraph) -> np.ndarray:
    """int32[n] longest-path level of each DAG vertex (sources = 0).

    Level-synchronous Kahn rounds, all-numpy: a vertex's in-degree hits
    zero exactly when its last predecessor's round finishes, so the round
    it enters the frontier IS its longest-path level.  ``u -> v`` (u != v)
    implies ``level[u] < level[v]`` — the serve-path prefilter's invariant.
    """
    n = g.n
    indptr = g.indptr.astype(np.int64)
    indices = g.indices.astype(np.int64)
    indeg = np.bincount(indices, minlength=n)
    level = np.zeros(n, dtype=np.int32)
    frontier = np.flatnonzero(indeg == 0)
    lv = 0
    seen = frontier.size
    while frontier.size:
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total = int(counts.sum())
        lv += 1
        if total == 0:
            break
        cum = np.cumsum(counts)
        offs = np.repeat(starts - (cum - counts), counts) + np.arange(total, dtype=np.int64)
        nbrs = indices[offs]
        indeg -= np.bincount(nbrs, minlength=n)
        uniq = np.unique(nbrs)
        frontier = uniq[indeg[uniq] == 0]
        level[frontier] = lv
        seen += frontier.size
    if seen != n:
        raise ValueError("graph has a cycle")
    return level


def topological_order(g: CSRGraph) -> np.ndarray:
    """Topological order of a DAG (raises on cycles). int32[n]: order[i] = i-th vertex."""
    indeg = g.in_degree().astype(np.int64)
    stack = list(np.nonzero(indeg == 0)[0][::-1])
    out = np.empty(g.n, dtype=np.int32)
    k = 0
    while stack:
        v = stack.pop()
        out[k] = v
        k += 1
        for w in g.out_neighbors(v):
            indeg[w] -= 1
            if indeg[w] == 0:
                stack.append(int(w))
    if k != g.n:
        raise ValueError("graph has a cycle")
    return out
