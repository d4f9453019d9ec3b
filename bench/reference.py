"""The plain reference: what Distribution-Labeling's first iterations
write, in plain torch operations from the benchmark's own inputs.

It imports nothing of the program and reads nothing the program made.  It
is written another way than the program on purpose: the labels by a
frontier BFS over a CSR where the program sweeps every edge each step, the
prune test by comparing each hop where the program looks hops up in a
table.
"""
from __future__ import annotations

import torch

from bench.gen import INVALID


def csr(src: torch.Tensor, dst: torch.Tensor, n: int) -> tuple:
    """(indptr int64[n + 1], indices int64[m]) of the edges src -> dst."""
    order = torch.argsort(src, stable=True)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    indptr[1:] = torch.cumsum(torch.bincount(src.long(), minlength=n), 0)
    return indptr, dst.long()[order]


def _neighbours(graph: tuple, frontier: torch.Tensor) -> torch.Tensor:
    indptr, indices = graph
    starts = indptr[frontier]
    counts = indptr[frontier + 1] - starts
    first = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())
    idx = torch.repeat_interleave(starts - first, counts, output_size=total)
    return indices[idx + torch.arange(total, device=idx.device)]


def reach(graph: tuple, source: int, pruned: torch.Tensor, max_steps: int,
          short: bool = False) -> torch.Tensor:
    """bool[n]: the vertices a BFS from ``source`` reaches within
    ``max_steps`` levels, where a pruned vertex is reached but not expanded.
    ``short`` leaves the deepest level out (the control: a traversal that
    stops one level early)."""
    n = pruned.shape[0]
    visited = torch.zeros(n, dtype=torch.bool, device=pruned.device)
    visited[source] = True
    frontier = torch.tensor([] if bool(pruned[source]) else [source], dtype=torch.int64,
                            device=pruned.device)
    last = None
    for _ in range(max_steps):
        if frontier.numel() == 0:
            break
        nb = _neighbours(graph, frontier)
        nb = torch.unique(nb[~visited[nb]])
        if nb.numel() == 0:
            break
        visited[nb] = True
        last = nb
        frontier = nb[~pruned[nb]]
    if short and last is not None:
        visited[last] = False
    return visited


def _covered(L: torch.Tensor, hops: torch.Tensor) -> torch.Tensor:
    """bool[n]: row w of ``L`` holds one of ``hops``."""
    out = torch.zeros(L.shape[0], dtype=torch.bool, device=L.device)
    for h in hops.tolist():
        out |= (L == h).any(1)
    return out


def _append(L: torch.Tensor, lens: torch.Tensor, labeled: torch.Tensor, vi: int) -> bool:
    """Write ``vi`` after the entries of every labeled row (into the last
    column of a full row), in place; whether a row was full."""
    rows = torch.nonzero(labeled).flatten()
    had = lens[rows]
    L[rows, had.clamp(max=L.shape[1] - 1).long()] = vi
    lens[rows] += 1
    return bool((had >= L.shape[1]).any())


def distribute(src: torch.Tensor, dst: torch.Tensor, order: torch.Tensor, n: int, l_max: int,
               max_steps: int, short: bool = False) -> dict:
    """The label state after Distribution-Labeling's iterations over
    ``order`` from empty labels (Algorithm 2 of arXiv 1305.0502): for each
    vertex vi in turn, every ancestor u that the BFS over the reversed edges
    reaches, and whose ``L_out`` shares no hop with ``L_in(vi)``, gains vi in
    ``L_out``; then every descendant w reached over the edges, whose ``L_in``
    shares no hop with the new ``L_out(vi)``, gains vi in ``L_in``.  A vertex
    that shares a hop is reached but not expanded.  Entries lie in the order
    written; ``overflow`` marks a row that had ``l_max`` entries already."""
    dev = src.device
    fwd, rev = csr(src, dst, n), csr(dst, src, n)
    state = {"L_out": torch.full((n, l_max), INVALID, dtype=torch.int32, device=dev),
             "L_in": torch.full((n, l_max), INVALID, dtype=torch.int32, device=dev),
             "out_len": torch.zeros(n, dtype=torch.int32, device=dev),
             "in_len": torch.zeros(n, dtype=torch.int32, device=dev)}
    overflow = False
    for vi in order.tolist():
        for L, lens, other, other_lens, graph in (
                ("L_out", "out_len", "L_in", "in_len", rev),
                ("L_in", "in_len", "L_out", "out_len", fwd)):
            hops = state[other][vi, :int(state[other_lens][vi])]
            pruned = _covered(state[L], hops)
            labeled = reach(graph, vi, pruned, max_steps, short) & ~pruned
            overflow |= _append(state[L], state[lens], labeled, vi)
    state["overflow"] = torch.tensor(overflow, device=dev)
    return state
