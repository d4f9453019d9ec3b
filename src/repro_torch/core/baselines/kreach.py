"""K-Reach (Cheng et al., VLDB 2012) specialized to basic reachability (k=inf).

Vertex-cover based: greedily 2-approximate a vertex cover C of the DAG, then
fully materialize pairwise reachability among C (bitsets). Every edge has an
endpoint in C, so any path alternates into C quickly:

  query(u, v):  u,v in C        -> lookup
                u in C, v not   -> exists in-cover in-neighbor b of v: u ~> b
                u not, v in C   -> exists out-cover neighbor a of u: a ~> v
                neither         -> direct edge u->v, or a in N_out(u) cap C,
                                   b in N_in(v) cap C with a ~> b

The paper's observation (§2.3): the pairwise materialization over C is what
kills this approach on large graphs — C is often a large fraction of V.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.reach import transitive_closure_bits


class KReach:
    name = "K-REACH"

    def __init__(self, g: CSRGraph):
        self.g = g
        n = g.n
        # greedy 2-approx vertex cover: repeatedly take both endpoints of an
        # uncovered edge (classic maximal matching).
        in_cover = np.zeros(n, dtype=bool)
        src, dst = g.edges()
        for a, b in zip(src, dst):
            if not (in_cover[a] or in_cover[b]):
                in_cover[a] = True
                in_cover[b] = True
        self.in_cover = in_cover
        cover = np.nonzero(in_cover)[0].astype(np.int32)
        self.cover = cover
        self.cover_id = np.full(n, -1, dtype=np.int32)
        self.cover_id[cover] = np.arange(cover.shape[0], dtype=np.int32)

        # pairwise reachability among cover, via the full-graph closure
        # projected onto C (an induced-subgraph closure would lose paths
        # through non-cover interior vertices).
        tc_full = transitive_closure_bits(g)
        kc = cover.shape[0]
        words_c = (kc + 31) // 32
        self.tc_cover = np.zeros((kc, words_c), dtype=np.uint32)
        for i, a in enumerate(cover):
            bits = np.unpackbits(tc_full[int(a)].view(np.uint8), bitorder="little")[:n]
            reach_cover = np.nonzero(bits[cover])[0]
            for j in reach_cover:
                self.tc_cover[i, j >> 5] |= np.uint32(1) << np.uint32(j & 31)

    @property
    def index_size_ints(self) -> int:
        return int(self.tc_cover.size) + self.g.n

    def _cc(self, i: int, j: int) -> bool:
        """cover-local reachability lookup (i, j cover ids)."""
        if i == j:
            return True
        return bool((self.tc_cover[i, j >> 5] >> np.uint32(j & 31)) & np.uint32(1))

    def query(self, u: int, v: int) -> bool:
        if u == v:
            return True
        g, cid = self.g, self.cover_id
        iu, iv = int(cid[u]), int(cid[v])
        if iu >= 0 and iv >= 0:
            return self._cc(iu, iv)
        if iu >= 0:
            # v not in cover: all in-edges of v come from cover
            rev_nbrs = [int(x) for x in self._in_neighbors(v)]
            return any(self._cc(iu, int(cid[b])) for b in rev_nbrs if cid[b] >= 0)
        if iv >= 0:
            out_nbrs = g.out_neighbors(u)
            return any(self._cc(int(cid[a]), iv) for a in out_nbrs if cid[a] >= 0)
        # neither in cover: direct edge, else through two cover vertices
        out_nbrs = [int(a) for a in g.out_neighbors(u)]
        if v in out_nbrs:
            return True
        in_nbrs = [int(b) for b in self._in_neighbors(v)]
        ca = [int(cid[a]) for a in out_nbrs if cid[a] >= 0]
        cb = [int(cid[b]) for b in in_nbrs if cid[b] >= 0]
        return any(self._cc(a, b) for a in ca for b in cb)

    def _in_neighbors(self, v: int):
        if not hasattr(self, "_grev"):
            self._grev = self.g.reverse()
        return self._grev.out_neighbors(v)


def build(g: CSRGraph) -> KReach:
    return KReach(g)
