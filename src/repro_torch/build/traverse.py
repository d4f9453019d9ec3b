"""Scalar traversal helpers of the port's construction code.

``pruned_bfs_distribute`` is the loop the reference Distribution-Labeling
build runs twice per vertex (reverse, then forward pass);
``cone_resume_sweep`` resumes one direction of it from an arbitrary seed,
the entry ``repro_torch.dynamic`` repairs labels through; ``khop_out`` and
``batched_union_rows`` serve the backbone builder and Hierarchical-Labeling.
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


def cone_resume_sweep(
    neighbors,
    labels,
    hop: int,
    hop_vertex: int,
    seed: int,
    side: str,
    stop_at_present: bool,
) -> int:
    """Resume one direction of Algorithm 2's pruned BFS from an arbitrary
    seed — the cone-scoped construction entry (re-exported by
    ``build.engine``) that ``repro_torch.dynamic`` repairs labels through.

    The same prune-or-expand loop as ``pruned_bfs_distribute``, generalized
    for the dynamic path: the prune probe and the label append go through
    the ``labels`` object (rank-restricted, idempotent) instead of raw
    sets/lists, because repairs run against finalized rank-space labels.

    Where the wave engine runs every BFS of a wave from its own hop vertex
    over the whole graph, a dynamic repair restarts a single hop's sweep
    inside the affected cone only: after inserting DAG edge (u, v), hop h in
    L_in(u) resumes its FORWARD sweep at seed v (``side="in"``: distributing
    h into L_in of v's cone), and hop h in L_out(v) resumes its REVERSE sweep
    at seed u (``side="out"``).  Cones are tiny relative to n, so the scalar
    level loop beats re-running the batched wave sweep; the prune test is the
    same Algorithm 2 probe, restricted to ranks at least as high as ``hop``
    (numerically ``<= hop`` in rank space) so the verdicts match what the
    sequential §5.2 loop would have produced — repaired labels stay
    non-redundant per Theorem 4 up to covers that later edge updates created.

    Parameters
    ----------
    neighbors : callable v -> iterable of neighbor vertex ids
        Forward adjacency for ``side="in"``, reverse for ``side="out"``.
    labels : MutableLabels-protocol
        Must provide ``prune(vertex, hop, hop_vertex, side, include_equal)``
        (the restricted intersection probe; with ``include_equal`` an
        already-present hop also prunes) and ``add(side, vertex, hop)``
        (idempotent sorted insert).
    hop : int
        Rank-space value being distributed.
    hop_vertex : int
        The vertex whose rank is ``hop`` (its opposite-side row feeds the
        prune probe).
    seed : int
        Cone apex the sweep restarts from.
    side : str
        "in": write L_in rows (forward sweep); "out": write L_out rows.
    stop_at_present : bool
        True for insert repairs (a vertex already holding ``hop`` was fully
        explored when the hop first reached it — prune and do not expand);
        False for delete repairs (rows beyond a present vertex may have been
        invalidated and must be revisited).

    Returns the number of label appends performed.
    """
    appended = 0
    dq = deque([seed])
    seen = {seed}
    while dq:
        w = dq.popleft()
        if labels.prune(w, hop, hop_vertex, side, include_equal=stop_at_present):
            continue
        appended += labels.add(side, w, hop)
        for x in neighbors(w):
            if x not in seen:
                seen.add(x)
                dq.append(x)
    return appended


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
