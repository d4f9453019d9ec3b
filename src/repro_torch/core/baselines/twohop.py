"""Cohen et al. 2-hop labeling via greedy set cover [11] (the paper's 2HOP).

The classic construction the paper is beating: materialize the transitive
closure, then greedily select hops with a lazy (accelerated) greedy over the
"star" candidate family: hop w covers uncovered pairs in
(TC^-1(w) u {w}) x (TC(w) u {w}); benefit = newly covered / (|X| + |Y|).
Benefits only decrease as coverage grows (submodular), so a lazy priority
queue avoids full re-evaluation.

Deliberately faithful to the paper's complaint: requires the FULL transitive
closure (O(n^2/32) words) and repeated benefit scans — it is slow and
memory-hungry on large graphs (it fails there in the paper's Table 7 too;
benchmarks run it at reduced scale).
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.build.bitset import popcount_u64
from repro_torch.core.oracle import ReachabilityOracle, finalize_labels
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.reach import transitive_closure_bits


def _bits_to_indices(row: np.ndarray) -> np.ndarray:
    return np.nonzero(np.unpackbits(row.view(np.uint8), bitorder="little"))[0]


class TwoHopSetCover:
    name = "2HOP"

    def __init__(self, g: CSRGraph, max_rounds: int | None = None):
        n = g.n
        tc = transitive_closure_bits(g)  # tc[u] = bitset of TC(u), no self bits
        # reverse closure bitsets
        rtc = np.zeros_like(tc)
        for u in range(n):
            for v in _bits_to_indices(tc[u]):
                rtc[v, u >> 5] |= np.uint32(1) << np.uint32(u & 31)

        uncovered = tc.copy()
        out_lists: list[list[int]] = [[w] for w in range(n)]  # self hops
        in_lists: list[list[int]] = [[w] for w in range(n)]

        def star(w: int):
            """(xs, ys_plus_bits): candidate sources and target bitset (TC(w)+{w})."""
            xs = _bits_to_indices(rtc[w])
            ys_plus = tc[w].copy()
            ys_plus[w >> 5] |= np.uint32(1) << np.uint32(w & 31)
            return xs, ys_plus

        def benefit(w: int) -> float:
            xs, ys_plus = star(w)
            rows = np.concatenate([xs, [w]])
            new = int(popcount_u64(uncovered[rows] & ys_plus[None, :]).sum())
            cost = rows.shape[0] + int(popcount_u64(ys_plus).sum())
            return new / max(cost, 1)

        heap = [(-benefit(w), 0, w) for w in range(n)]
        heapq.heapify(heap)
        version = np.zeros(n, dtype=np.int64)
        total_uncovered = int(popcount_u64(uncovered).sum())
        rounds, cap = 0, (max_rounds if max_rounds is not None else 8 * n)

        while total_uncovered > 0 and heap and rounds < cap:
            neg_b, ver, w = heapq.heappop(heap)
            if ver != version[w]:  # stale: refresh lazily
                version[w] += 1
                heapq.heappush(heap, (-benefit(w), int(version[w]), w))
                continue
            if -neg_b <= 0:
                break
            rounds += 1
            xs, ys_plus = star(w)
            rows = np.concatenate([xs, [w]]).astype(np.int64)
            gain_rows = rows[popcount_u64(uncovered[rows] & ys_plus[None, :]) > 0]
            if gain_rows.shape[0] == 0:
                version[w] += 1
                continue
            # targets that still need w in L_in: union of uncovered&TC(w) over gainers
            need = np.bitwise_or.reduce(uncovered[gain_rows] & tc[w][None, :], axis=0)
            for y in _bits_to_indices(need):
                in_lists[int(y)].append(w)
            for u in gain_rows:
                u = int(u)
                if u != w:
                    out_lists[u].append(w)
                covered_now = uncovered[u] & ys_plus
                uncovered[u] &= ~ys_plus
                total_uncovered -= int(popcount_u64(covered_now).sum())
            version[gain_rows] += 1
            version[w] += 1

        self.oracle: ReachabilityOracle = finalize_labels(out_lists, in_lists)

    @property
    def index_size_ints(self) -> int:
        return self.oracle.total_label_size

    def query(self, u: int, v: int) -> bool:
        if u == v:
            return True
        return self.oracle.query(u, v)


def build(g: CSRGraph) -> TwoHopSetCover:
    return TwoHopSetCover(g)
