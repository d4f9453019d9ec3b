"""Interval transitive-closure compression (Nuutila [21] / Agrawal [2] style).

Vertices are numbered by DFS post-order over a spanning forest, so every
tree-descendant range is contiguous. TC(v) is stored as a sorted list of
disjoint intervals over that numbering, computed in one reverse-topological
sweep: intervals(v) = merge(own tree interval, intervals of out-neighbors).

Query(u, v): binary-search post(v) in u's interval list — the "fastest query"
family in the paper's small-graph tables.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, topological_order


def _merge_intervals(parts: list[np.ndarray]) -> np.ndarray:
    """parts: list of int32[k_i, 2] sorted disjoint intervals -> merged."""
    if not parts:
        return np.empty((0, 2), dtype=np.int32)
    cat = np.concatenate(parts, axis=0)
    cat = cat[np.argsort(cat[:, 0], kind="stable")]
    out = []
    cur_s, cur_e = int(cat[0, 0]), int(cat[0, 1])
    for s, e in cat[1:]:
        s, e = int(s), int(e)
        if s <= cur_e + 1:
            cur_e = max(cur_e, e)
        else:
            out.append((cur_s, cur_e))
            cur_s, cur_e = s, e
    out.append((cur_s, cur_e))
    return np.asarray(out, dtype=np.int32)


class IntervalTC:
    name = "INTERVAL"

    def __init__(self, g: CSRGraph):
        self.g = g
        n = g.n
        # spanning-forest DFS post-order numbering
        post = np.full(n, -1, dtype=np.int32)
        tree_lo = np.full(n, -1, dtype=np.int32)  # min post in tree subtree
        counter = 0
        visited = np.zeros(n, dtype=bool)
        indptr, indices = g.indptr, g.indices
        roots = list(np.nonzero(g.in_degree() == 0)[0]) + list(range(n))
        for s in roots:
            if visited[s]:
                continue
            visited[s] = True
            stack = [(int(s), int(indptr[s]), counter)]
            while stack:
                v, ei, lo_at_entry = stack[-1]
                if ei < indptr[v + 1]:
                    stack[-1] = (v, ei + 1, lo_at_entry)
                    w = int(indices[ei])
                    if not visited[w]:
                        visited[w] = True
                        stack.append((w, int(indptr[w]), counter))
                else:
                    stack.pop()
                    post[v] = counter
                    tree_lo[v] = lo_at_entry
                    counter += 1
        self.post = post

        # reverse-topo interval merge
        self.intervals: list[np.ndarray] = [np.empty((0, 2), np.int32)] * n
        topo = topological_order(g)
        for v in topo[::-1]:
            v = int(v)
            parts = [np.array([[tree_lo[v], post[v]]], dtype=np.int32)]
            for w in g.out_neighbors(v):
                parts.append(self.intervals[int(w)])
            self.intervals[v] = _merge_intervals(parts)

    @property
    def index_size_ints(self) -> int:
        return int(sum(iv.size for iv in self.intervals)) + self.g.n

    def query(self, u: int, v: int) -> bool:
        if u == v:
            return True
        iv = self.intervals[u]
        p = self.post[v]
        lo_idx = int(np.searchsorted(iv[:, 0], p, side="right")) - 1
        if lo_idx < 0:
            return False
        s, e = iv[lo_idx]
        if not (s <= p <= e):
            return False
        # own tree interval includes u itself; exclude the self-hit only
        return True if p != self.post[u] else False


def build(g: CSRGraph) -> IntervalTC:
    return IntervalTC(g)
