"""Frontier-vector BFS on the device, the port of ``repro.graph.bfs``.

The frontier is a dense bool[n] vector; one step gathers every
frontier-adjacent edge and scatter-ORs into the next frontier with a
``scatter_reduce`` ``amax`` (JAX's ``segment_max``).  Multi-source BFS keeps
a bool[s, n] frontier matrix and takes the same step on every row at once.

The loops are plain Python loops that stop when the frontier stops growing
(one host read a step), where JAX runs ``lax.while_loop``.  The functions
run wherever their tensors lie; ``csr_device_arrays`` and
``multi_source_reach`` put them on the card unless given ``device="cpu"``.
Nothing in the port calls this module; it is kept for parity with the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph


def csr_device_arrays(g: CSRGraph, device="cuda"):
    """(src int32[m], dst int32[m]) edge list on ``device``, sorted by src."""
    dev = resolve_device(device)
    src, dst = g.edges()
    return torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)


def _hits(active: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """bool[..., n]: whether some edge into each vertex is active; active is
    bool[..., m] over the edges, dst their int destinations."""
    idx = dst.long().expand(active.shape)
    out = torch.zeros((*active.shape[:-1], n), dtype=torch.int32, device=active.device)
    return out.scatter_reduce_(-1, idx, active.to(torch.int32), "amax") > 0


def bfs_step(reached: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """One OR-step: reached |= exists edge (u->v) with reached[u].

    reached: bool[n]. Returns new reached (monotone).
    """
    return reached | _hits(reached[src.long()], dst, n)


def bfs_reach(sources: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, n: int,
              max_steps: int) -> torch.Tensor:
    """bool[n] reachable-set (inclusive of sources) after <= max_steps steps.

    sources: bool[n] initial frontier.  Stops early when the frontier stops
    growing.
    """
    reached = sources
    for _ in range(max_steps):
        new = bfs_step(reached, src, dst, n)
        if torch.equal(new, reached):
            break
        reached = new
    return reached


def k_hop_neighborhood(sources: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, n: int,
                       k: int) -> torch.Tensor:
    """bool[n]: vertices within <= k forward steps of sources (inclusive)."""
    reached = sources
    for _ in range(k):
        reached = bfs_step(reached, src, dst, n)
    return reached


def bfs_levels_device(source, src: torch.Tensor, dst: torch.Tensor, n: int,
                      max_steps: int) -> torch.Tensor:
    """int32[n] levels from a single source index; -1 unreached."""
    level = torch.full((n,), -1, dtype=torch.int32, device=src.device)
    level[int(source)] = 0
    for step in range(max_steps):
        reached = level >= 0
        fresh = bfs_step(reached, src, dst, n) & ~reached
        if not bool(fresh.any()):
            break
        level[fresh] = step + 1
    return level


def multi_source_reach(sources: np.ndarray, g: CSRGraph, max_steps: int | None = None,
                       device="cuda") -> np.ndarray:
    """bool[s, n]: row i = reachable set of sources[i]. Batched frontier matrix."""
    n = g.n
    src, dst = csr_device_arrays(g, device)
    steps = n if max_steps is None else max_steps
    sources = torch.as_tensor(np.asarray(sources), device=src.device).long()
    reached = torch.zeros((sources.shape[0], n), dtype=torch.bool, device=src.device)
    reached[torch.arange(sources.shape[0], device=src.device), sources] = True
    for _ in range(steps):
        new = reached | _hits(reached[:, src.long()], dst, n)
        if torch.equal(new, reached):
            break
        reached = new
    return reached.cpu().numpy()
