"""GRAIL [Yildirim et al., PVLDB 2010]: random-DFS min-post interval labels.

Each of k traversals assigns L_t(v) = [min_post_in_subtree(v), post(v)].
Invariant: u reaches v  =>  L_t(v) is contained in L_t(u) for every t.
A query first tries to *refute* via non-containment; if all k labelings are
consistent, fall back to a DFS that prunes with the same test.

The paper uses 5 traversals (its §6.1 choice); we default to the same.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


class Grail:
    name = "GRAIL"

    def __init__(self, g: CSRGraph, k: int = 5, seed: int = 0):
        self.g = g
        self.k = k
        n = g.n
        self.lo = np.zeros((k, n), dtype=np.int32)  # min post in subtree
        self.hi = np.zeros((k, n), dtype=np.int32)  # own post
        rng = np.random.default_rng(seed)
        roots = np.nonzero(g.in_degree() == 0)[0]
        for t in range(k):
            self._random_dfs(t, rng, roots)
        self._stamp = np.full(n, -1, dtype=np.int64)
        self._qid = 0

    def _random_dfs(self, t: int, rng: np.random.Generator, roots: np.ndarray) -> None:
        g = self.g
        n = g.n
        visited = np.zeros(n, dtype=bool)
        post = 0
        lo, hi = self.lo[t], self.hi[t]
        order = rng.permutation(roots)
        # also cover vertices unreachable from roots (cycles impossible in DAG,
        # but isolated subgraphs may lack 0-indegree entry after generators)
        all_starts = list(order) + [v for v in rng.permutation(n)]
        for s in all_starts:
            if visited[s]:
                continue
            stack = [(int(s), iter(rng.permutation(g.out_neighbors(int(s)))))]
            visited[s] = True
            while stack:
                v, it = stack[-1]
                advanced = False
                for w in it:
                    w = int(w)
                    if not visited[w]:
                        visited[w] = True
                        stack.append((w, iter(rng.permutation(g.out_neighbors(w)))))
                        advanced = True
                        break
                if not advanced:
                    stack.pop()
                    # children all done: lo = min(own post about to be assigned, children lo)
                    child_lo = post
                    for w in g.out_neighbors(v):
                        child_lo = min(child_lo, lo[w])
                    lo[v] = child_lo
                    hi[v] = post
                    post += 1

    @property
    def index_size_ints(self) -> int:
        return 2 * self.k * self.g.n

    def _maybe(self, u: int, v: int) -> bool:
        """False => definitely unreachable."""
        return bool(np.all((self.lo[:, u] <= self.lo[:, v]) & (self.hi[:, v] <= self.hi[:, u])))

    def query(self, u: int, v: int) -> bool:
        if u == v:
            return True
        if not self._maybe(u, v):
            return False
        # pruned DFS
        g = self.g
        self._qid += 1
        stamp, qid = self._stamp, self._qid
        stack = [u]
        stamp[u] = qid
        while stack:
            x = stack.pop()
            if x == v:
                return True
            for w in g.out_neighbors(x):
                w = int(w)
                if stamp[w] != qid and self._maybe(w, v):
                    stamp[w] = qid
                    stack.append(w)
        return False


def build(g: CSRGraph, k: int = 5, seed: int = 0) -> Grail:
    return Grail(g, k=k, seed=seed)
