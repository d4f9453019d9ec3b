"""Scalar pruned-BFS / label-append helper of the reference construction.

The port carries only ``pruned_bfs_distribute``, the loop the reference
Distribution-Labeling build runs twice per vertex (reverse, then forward
pass).  The cone-resume sweep and the k-hop helpers come with the slices
that need them (dynamic repair, Hierarchical-Labeling).
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
