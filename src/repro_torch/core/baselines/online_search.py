"""The no-index extreme: query-time BFS with early exit (paper §2.1)."""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.graph.csr import CSRGraph


class OnlineBFS:
    name = "BFS"

    def __init__(self, g: CSRGraph):
        self.g = g
        self._stamp = np.full(g.n, -1, dtype=np.int64)
        self._qid = 0

    @property
    def index_size_ints(self) -> int:
        return 0  # no index

    def query(self, u: int, v: int) -> bool:
        if u == v:
            return True
        g = self.g
        self._qid += 1
        stamp, qid = self._stamp, self._qid
        dq = deque([u])
        stamp[u] = qid
        indptr, indices = g.indptr, g.indices
        while dq:
            x = dq.popleft()
            for w in indices[indptr[x] : indptr[x + 1]]:
                if w == v:
                    return True
                if stamp[w] != qid:
                    stamp[w] = qid
                    dq.append(int(w))
        return False


def build(g: CSRGraph) -> OnlineBFS:
    return OnlineBFS(g)


def bidirectional_query(
    g: CSRGraph,
    g_rev: CSRGraph,
    u: int,
    v: int,
    node_budget: int | None = None,
) -> bool:
    """Exact label-free reachability: alternating bidirectional BFS.

    The serve engine's last degradation rung — when labels are corrupt or
    unavailable it must still return a CORRECT verdict, so this is an exact
    search, not a heuristic.  Each round expands the currently *smaller*
    frontier (forward from ``u`` over ``g``, backward from ``v`` over
    ``g_rev``); any overlap proves u -> v.  ``node_budget`` bounds only the
    bidirectional phase: once the smaller-frontier expansions have popped
    that many nodes, the search completes forward-only from the surviving
    forward frontier (still exact — the budget trades the meet-in-the-middle
    speedup away, never correctness)."""
    if u == v:
        return True
    seen_f = np.zeros(g.n, dtype=bool)
    seen_b = np.zeros(g.n, dtype=bool)
    seen_f[u] = True
    seen_b[v] = True
    front_f = np.asarray([u], dtype=np.int64)
    front_b = np.asarray([v], dtype=np.int64)
    popped = 0

    def _expand(front, indptr, indices, seen):
        counts = indptr[front + 1] - indptr[front]
        if not counts.sum():
            return np.empty(0, dtype=np.int64)
        nbrs = np.concatenate([indices[indptr[x]: indptr[x + 1]] for x in front])
        nbrs = np.unique(nbrs)
        fresh = nbrs[~seen[nbrs]]
        seen[fresh] = True
        return fresh

    while front_f.size and front_b.size:
        if node_budget is not None and popped >= node_budget:
            break
        if front_f.size <= front_b.size:
            popped += front_f.size
            front_f = _expand(front_f, g.indptr, g.indices, seen_f)
            if seen_b[front_f].any():
                return True
        else:
            popped += front_b.size
            front_b = _expand(front_b, g_rev.indptr, g_rev.indices, seen_b)
            if seen_f[front_b].any():
                return True
    if not front_f.size or not front_b.size:
        return False
    # budget exhausted: finish forward-only (seen_f already prunes revisits)
    while front_f.size:
        front_f = _expand(front_f, g.indptr, g.indices, seen_f)
        if seen_b[front_f].any():
            return True
    return False
