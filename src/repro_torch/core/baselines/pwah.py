"""Bit-vector transitive-closure compression (van Schaik & de Moor [29]).

PWAH-8 partitions words into 8-bit blocks with run-length-encoded fill words.
We implement the same idea at word granularity: each vertex's closure bitset
(over a topological renumbering, which clusters reachable ids into runs) is
stored as (word_index, word) pairs for non-zero words — a sparse word-aligned
hybrid. Query = binary search the word index, test the bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, topological_order


class PWAHBitvector:
    name = "PWAH"

    def __init__(self, g: CSRGraph):
        self.g = g
        n = g.n
        topo = topological_order(g)
        rank = np.empty(n, dtype=np.int64)
        rank[topo] = np.arange(n)
        self.rank = rank.astype(np.int32)
        words = (n + 31) // 32

        # reverse-topo closure sweep with dense scratch row, stored sparse.
        self.word_idx: list[np.ndarray] = [None] * n  # type: ignore
        self.word_val: list[np.ndarray] = [None] * n  # type: ignore
        scratch = np.zeros(words, dtype=np.uint32)
        for v in topo[::-1]:
            v = int(v)
            scratch[:] = 0
            for w in g.out_neighbors(v):
                w = int(w)
                scratch[self.word_idx[w]] |= self.word_val[w]
                rw = int(rank[w])
                scratch[rw >> 5] |= np.uint32(1) << np.uint32(rw & 31)
            nz = np.nonzero(scratch)[0]
            self.word_idx[v] = nz.astype(np.int32)
            self.word_val[v] = scratch[nz].copy()

    @property
    def index_size_ints(self) -> int:
        return int(sum(w.size * 2 for w in self.word_idx))

    def query(self, u: int, v: int) -> bool:
        if u == v:
            return True
        rv = int(self.rank[v])
        wi = rv >> 5
        idx = self.word_idx[u]
        k = int(np.searchsorted(idx, wi))
        if k >= idx.shape[0] or idx[k] != wi:
            return False
        return bool((self.word_val[u][k] >> np.uint32(rv & 31)) & np.uint32(1))


def build(g: CSRGraph) -> PWAHBitvector:
    return PWAHBitvector(g)
