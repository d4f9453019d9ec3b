"""One-side reachability backbone (paper Definition 1; SCARAB's FastCover).

For locality threshold eps (=2 throughout, as in the paper):

  V*  s.t. every pair (u, w) with d(u, w) = eps has a covering vertex x in V*
      with d(u, x) <= eps and d(x, w) <= eps.
  E*  = {(a, b) in V* x V* : d(a, b) <= eps + 1}, minus edges made redundant
      by an intermediate backbone vertex (paper's reduction rule).

Our FastCover variant is greedy-by-midpoint: process candidate midpoints x in
descending rank (dout+1)(din+1); select x iff some 2-pair through x is still
uncovered; selecting x covers all pairs N_in(x) x N_out(x). A pair is also
covered when u or w themselves are selected. This is conservative (never
marks an uncovered pair covered), so Definition 1 holds by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set

import numpy as np

from repro_torch.build.traverse import khop_out as _khop_out
from repro_torch.core.order import degree_product_rank
from repro_torch.graph.csr import CSRGraph, from_edges


@dataclasses.dataclass(frozen=True)
class Backbone:
    """Backbone of one decomposition level (vertex ids are *parent-graph local*)."""

    vstar: np.ndarray      # int32[k] selected vertex ids (parent-local), sorted
    graph: CSRGraph        # backbone graph over 0..k-1 (backbone-local ids)
    local_of: Dict[int, int]  # parent-local id -> backbone-local id


def fast_cover(g: CSRGraph, eps: int = 2) -> np.ndarray:
    """Select V* (bool[n]) for the one-side backbone, eps=2 specialization."""
    assert eps == 2, "this implementation specializes the paper's eps=2 setting"
    n = g.n
    g_rev = g.reverse()
    order = degree_product_rank(g)
    in_vstar = np.zeros(n, dtype=bool)
    covered: Set[int] = set()  # packed pair keys u * n + w

    indptr, indices = g.indptr, g.indices
    r_indptr, r_indices = g_rev.indptr, g_rev.indices

    for x in order:
        x = int(x)
        ins = r_indices[r_indptr[x] : r_indptr[x + 1]]
        outs = indices[indptr[x] : indptr[x + 1]]
        if ins.shape[0] == 0 or outs.shape[0] == 0:
            continue
        # does x have an uncovered 2-pair through it?
        selected = False
        for u in ins:
            u = int(u)
            if in_vstar[u]:
                continue  # all pairs from u are covered by u itself
            base = u * n
            for w in outs:
                w = int(w)
                if w == u or in_vstar[w]:
                    continue
                if (base + w) not in covered:
                    selected = True
                    break
            if selected:
                break
        if not selected:
            continue
        in_vstar[x] = True
        # x covers every (u, w) in N_in(x) x N_out(x)
        for u in ins:
            base = int(u) * n
            for w in outs:
                if int(w) != int(u):
                    covered.add(base + int(w))
    return in_vstar


def build_backbone_graph(g: CSRGraph, in_vstar: np.ndarray, eps: int = 2) -> Backbone:
    """E*: backbone pairs within distance eps+1, with the reduction rule:
    drop (a,b) if some other backbone x has d(a,x)<=eps and d(x,b)<=eps."""
    vstar = np.nonzero(in_vstar)[0].astype(np.int32)
    local_of = {int(v): i for i, v in enumerate(vstar)}
    k = vstar.shape[0]

    # cov_in[y] = backbone vertices x with d(x, y) <= eps (capped) — used by
    # the reduction rule test  exists x: d(a,x)<=eps AND d(x,b)<=eps.
    cov_cap = 8
    cov_in: List[Set[int]] = [set() for _ in range(g.n)]
    for a in vstar:
        a = int(a)
        reach = _khop_out(g, a, eps)
        reach.add(a)
        for y in reach:
            if len(cov_in[y]) < cov_cap:
                cov_in[y].add(a)

    src: List[int] = []
    dst: List[int] = []
    for a in vstar:
        a = int(a)
        near = _khop_out(g, a, eps)          # d(a, .) <= eps
        far = _khop_out(g, a, eps + 1)       # d(a, .) <= eps+1
        near_bb = {x for x in near if in_vstar[x]}
        for b in far:
            if not in_vstar[b] or b == a:
                continue
            # reduction: skip if an intermediate backbone covers (a, b)
            redundant = any((x != a and x != b and x in near_bb) for x in cov_in[b])
            if not redundant:
                src.append(local_of[a])
                dst.append(local_of[b])
    graph = from_edges(k, np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64))
    return Backbone(vstar=vstar, graph=graph, local_of=local_of)


def one_side_backbone(g: CSRGraph, eps: int = 2) -> Backbone:
    return build_backbone_graph(g, fast_cover(g, eps), eps)
