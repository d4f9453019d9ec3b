"""Ground-truth reachability utilities (host, bit-packed numpy).

Used by tests (oracle completeness oracle), by the set-cover/PWAH/K-Reach
baselines that genuinely require transitive closure, and by positive-query
sampling for the paper's "equal" query workload.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, topological_order


def transitive_closure_bits(g: CSRGraph) -> np.ndarray:
    """Bit-packed transitive closure of a DAG.

    Returns uint32[n, ceil(n/32)]; bit j of row i set iff i -> j (i != j,
    reflexive bits NOT set).

    Single reverse-topological sweep: TC(v) = OR_{w in N_out(v)} (bit(w) | TC(w)).
    O(n * n/32) words.
    """
    n = g.n
    words = (n + 31) // 32
    tc = np.zeros((n, words), dtype=np.uint32)
    topo = topological_order(g)
    for v in topo[::-1]:
        row = tc[v]
        for w in g.out_neighbors(v):
            row |= tc[w]
            row[w >> 5] |= np.uint32(1) << np.uint32(w & 31)
    return tc


def adjacency_bits(g: CSRGraph) -> np.ndarray:
    """Bit-packed adjacency, uint32[n, ceil(n/32)]: bit j of row i set iff
    the edge i -> j exists; the start of ``R <- R | bitset_mm(R, R)``, whose
    fixpoint is ``transitive_closure_bits``."""
    A = np.zeros((g.n, (g.n + 31) // 32), dtype=np.uint32)
    src, dst = g.edges()
    np.bitwise_or.at(A, (src, dst >> 5), np.uint32(1) << (dst & 31).astype(np.uint32))
    return A


def reaches_bit(tc: np.ndarray, u: int, v: int) -> bool:
    return bool((tc[u, v >> 5] >> np.uint32(v & 31)) & np.uint32(1))


def reachable_set(g: CSRGraph, u: int) -> np.ndarray:
    """bool[n] of vertices reachable from u (excluding u unless on a cycle-free path)."""
    n = g.n
    seen = np.zeros(n, dtype=bool)
    stack = [int(u)]
    while stack:
        v = stack.pop()
        for w in g.out_neighbors(v):
            if not seen[w]:
                seen[w] = True
                stack.append(int(w))
    return seen


def bfs_levels(g: CSRGraph, u: int, max_steps: int | None = None) -> np.ndarray:
    """int32[n] BFS levels from u; -1 = unreached; level[u] = 0."""
    n = g.n
    level = np.full(n, -1, dtype=np.int32)
    level[u] = 0
    frontier = [int(u)]
    d = 0
    while frontier and (max_steps is None or d < max_steps):
        d += 1
        nxt = []
        for v in frontier:
            for w in g.out_neighbors(v):
                if level[w] == -1:
                    level[w] = d
                    nxt.append(int(w))
        frontier = nxt
    return level


def sample_query_workload(
    g: CSRGraph,
    n_queries: int,
    rng: np.random.Generator,
    equal: bool = True,
    tc: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Paper §6.1 query workloads.

    equal=True: ~50% positive / 50% negative pairs (positives sampled from TC).
    equal=False ("random"): uniform random pairs.
    Returns (queries int32[n_queries, 2], truth bool[n_queries]).
    """
    n = g.n
    if not equal:
        q = rng.integers(0, n, size=(n_queries, 2)).astype(np.int32)
        if tc is None:
            tc = transitive_closure_bits(g)
        truth = np.array([reaches_bit(tc, int(a), int(b)) for a, b in q])
        return q, truth

    if tc is None:
        tc = transitive_closure_bits(g)
    # positive pool: expand bit rows of random sources
    pos: list[tuple[int, int]] = []
    attempts = 0
    while len(pos) < n_queries // 2 and attempts < 50 * n_queries:
        attempts += 1
        u = int(rng.integers(0, n))
        row = tc[u]
        nz = np.nonzero(row)[0]
        if nz.shape[0] == 0:
            continue
        w = int(nz[rng.integers(0, nz.shape[0])])
        bits = int(row[w])
        choices = [b for b in range(32) if (bits >> b) & 1]
        v = (w << 5) + choices[int(rng.integers(0, len(choices)))]
        pos.append((u, v))
    neg: list[tuple[int, int]] = []
    while len(neg) < n_queries - len(pos):
        u = int(rng.integers(0, n))
        v = int(rng.integers(0, n))
        if u != v and not reaches_bit(tc, u, v):
            neg.append((u, v))
    q = np.array(pos + neg, dtype=np.int32)
    truth = np.array([True] * len(pos) + [False] * len(neg))
    perm = rng.permutation(q.shape[0])
    return q[perm], truth[perm]
