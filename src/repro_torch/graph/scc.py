"""Strongly-connected components (iterative Tarjan) + DAG condensation.

The paper (like all reachability work) assumes the input digraph has been
condensed: every SCC is coalesced into a single DAG vertex, so intra-SCC
reachability is trivially true.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph, from_edges


def tarjan_scc(g: CSRGraph) -> Tuple[np.ndarray, int]:
    """Iterative Tarjan. Returns (comp_id int32[n], n_comps).

    Component ids are assigned in *reverse topological order of the
    condensation* (Tarjan's natural output order), i.e. if comp(u) can reach
    comp(v) in the condensation and comp(u) != comp(v), then
    comp_id[u] > comp_id[v].
    """
    n = g.n
    index = np.full(n, -1, dtype=np.int64)
    low = np.zeros(n, dtype=np.int64)
    on_stack = np.zeros(n, dtype=bool)
    comp = np.full(n, -1, dtype=np.int32)
    stack: list[int] = []
    next_index = 0
    n_comps = 0

    indptr, indices = g.indptr, g.indices

    for root in range(n):
        if index[root] != -1:
            continue
        # (vertex, next-edge-offset) explicit DFS stack
        work = [(root, indptr[root])]
        index[root] = low[root] = next_index
        next_index += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, ei = work[-1]
            if ei < indptr[v + 1]:
                work[-1] = (v, ei + 1)
                w = int(indices[ei])
                if index[w] == -1:
                    index[w] = low[w] = next_index
                    next_index += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, indptr[w]))
                elif on_stack[w]:
                    if index[w] < low[v]:
                        low[v] = index[w]
            else:
                work.pop()
                if work:
                    pv = work[-1][0]
                    if low[v] < low[pv]:
                        low[pv] = low[v]
                if low[v] == index[v]:
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        comp[w] = n_comps
                        if w == v:
                            break
                    n_comps += 1
    return comp, n_comps


def condense_to_dag(g: CSRGraph) -> Tuple[CSRGraph, np.ndarray]:
    """Coalesce SCCs. Returns (dag, comp_id) with comp_id int32[n_original].

    The resulting DAG vertex ids are the component ids.
    """
    comp, k = tarjan_scc(g)
    src, dst = g.edges()
    csrc, cdst = comp[src], comp[dst]
    keep = csrc != cdst
    return from_edges(k, csrc[keep], cdst[keep]), comp
