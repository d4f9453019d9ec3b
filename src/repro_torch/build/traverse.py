"""Scalar traversal helpers of the port's construction code.

``pruned_bfs_distribute`` is the loop the reference Distribution-Labeling
build runs twice per vertex (reverse, then forward pass); ``khop_out`` and
``batched_union_rows`` serve the backbone builder and Hierarchical-Labeling.
The cone-resume sweep comes with the dynamic repair slice.
"""
from __future__ import annotations

from collections import deque
from typing import List, Set

import numpy as np


def pruned_bfs_distribute(
    indptr: np.ndarray,
    indices: np.ndarray,
    source: int,
    source_label_set: Set[int],
    target_label_sets: List[Set[int]],
    target_label_lists: List[List[int]],
    visited: np.ndarray,
    stamp: int,
) -> None:
    """One pruned-BFS pass of Algorithm 2 (paper §5).

    Walk the graph given by (indptr, indices) from ``source``; at each vertex
    ``u``, if ``source_label_set`` already intersects ``target_label_sets[u]``
    the pair is covered through a higher-ranked hop — prune ``u`` (no label,
    no expansion).  Otherwise append ``source`` to u's label and expand.

    The reverse pass of Distribution-Labeling calls this with the reverse CSR
    and (L_in(v_i), L_out); the forward pass with the forward CSR and
    (L_out(v_i), L_in).  ``visited`` is an iteration-stamp array shared across
    calls so it never needs clearing.
    """
    dq = deque([source])
    visited[source] = stamp
    while dq:
        u = dq.popleft()
        if not source_label_set.isdisjoint(target_label_sets[u]):
            continue  # covered by a higher hop: prune u (and paths through it)
        target_label_sets[u].add(source)
        target_label_lists[u].append(source)
        for w in indices[indptr[u] : indptr[u + 1]]:
            if visited[w] != stamp:
                visited[w] = stamp
                dq.append(int(w))


def khop_out(g, v: int, k: int) -> Set[int]:
    """Vertices within <= k forward steps of v (excluding v).

    Shared by the backbone builder (Formulas 1/2 candidate sets) and
    Hierarchical-Labeling (Formula 3 core labels + backbone sets).
    """
    seen = {v}
    frontier = [v]
    out: Set[int] = set()
    for _ in range(k):
        nxt = []
        for u in frontier:
            for w in g.out_neighbors(u):
                w = int(w)
                if w not in seen:
                    seen.add(w)
                    out.add(w)
                    nxt.append(w)
        frontier = nxt
    return out


def batched_union_rows(
    keys: np.ndarray, vals: np.ndarray, n_rows: int, domain: int
) -> List[np.ndarray]:
    """Per-key sorted-unique unions, one vectorized pass.

    (keys[t], vals[t]) pairs — vals in [0, domain) — collapse to a list of
    ``n_rows`` sorted unique int32 arrays (row k = union of vals with
    keys == k).  This is HL's level-wise label union (Formulas 4/5): all
    rows of a level are independent (they inherit only from higher-level
    backbone labels), so the whole level collapses into ONE np.unique over
    key-fused ints instead of a python set union per vertex.
    """
    fused = np.unique(keys.astype(np.int64) * np.int64(domain) + vals.astype(np.int64))
    k = fused // domain
    v = (fused % domain).astype(np.int32)
    starts = np.searchsorted(k, np.arange(n_rows + 1, dtype=np.int64))
    return [v[starts[i] : starts[i + 1]] for i in range(n_rows)]
