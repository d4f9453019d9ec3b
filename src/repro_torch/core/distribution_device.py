"""Vertex-wise device formulation of Distribution-Labeling.

The port of ``repro.core.distribution_jax``.  The per-vertex unit of work
in Algorithm 2 is re-expressed as dataflow:

  prune lookup:  lut[x] = x in L_out(v_i)   (scatter of one label row)
  prune test:    pruned[w] = any(lut[L_in(w, :)])          -- O(n*Lmax) gather
  masked BFS:    frontier sweep where only unpruned vertices expand
  label append:  L_in[w, in_len[w]] = v_i  for labeled w   -- one scatter

The outer vertex loop stays ordered (Theorem 2's V_s is the processed
prefix); every step inside an iteration is a dense torch op on the build's
device.  JAX jits the iteration and runs the BFS as a ``lax.while_loop``;
here the BFS is a Python loop over torch ops with one host read a step
(whether the step added a vertex).  JAX's version calls no Pallas kernel,
and neither does this one: it is plain torch ops on an explicit device.

Labels hold VERTEX ids (``hop_rank`` None), sorted ascending per row, as
JAX's do.  The wave-batched device build is ``repro_torch.build
.engine_device``; ``build_sweep_specs`` (the dry run's shapes) is not
ported: it serves ``launch/dryrun.py``, which the port does not have yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.oracle import ReachabilityOracle
from repro_torch.core.order import get_order
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph, INVALID

_INVALID = int(INVALID)


class LabelState(NamedTuple):
    L_out: torch.Tensor    # int32[n, Lmax]
    L_in: torch.Tensor     # int32[n, Lmax]
    out_len: torch.Tensor  # int32[n]
    in_len: torch.Tensor   # int32[n]
    overflow: torch.Tensor  # bool[] — any label row exceeded Lmax


def init_state(n: int, l_max: int, device="cuda") -> LabelState:
    """An empty label state on ``device`` (``"cuda"`` by default;
    ``RuntimeError`` without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return LabelState(
        L_out=torch.full((n, l_max), _INVALID, dtype=torch.int32, device=dev),
        L_in=torch.full((n, l_max), _INVALID, dtype=torch.int32, device=dev),
        out_len=torch.zeros(n, dtype=torch.int32, device=dev),
        in_len=torch.zeros(n, dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )


def _membership_lut(n: int, row: torch.Tensor) -> torch.Tensor:
    """bool[n + 1]: lut[x] = x appears in ``row`` (INVALID padded); slot n
    (where the padding parks) is cleared, so a gather through it reads
    False."""
    lut = torch.zeros(n + 1, dtype=torch.bool, device=row.device)
    lut[torch.where(row == _INVALID, n, row).long()] = True
    lut[n] = False
    return lut


def _masked_reach(source: int, pruned: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  n: int, max_steps: int) -> torch.Tensor:
    """bool[n]: vertices visited by BFS from ``source`` where pruned vertices
    do not expand.  Returns the VISITED set (includes pruned frontier hits).
    ``src``/``dst`` are int64 edge lists."""
    visited = torch.zeros(n, dtype=torch.bool, device=pruned.device)
    visited[source] = True
    for _ in range(max_steps):
        active = (visited & ~pruned)[src]
        hit = torch.zeros(n, dtype=torch.bool, device=pruned.device)
        hit[dst[active]] = True
        new = visited | hit
        if not bool((new != visited).any()):
            break
        visited = new
    return visited


def _dynamic_row(M: torch.Tensor, vi: int, mode: str) -> torch.Tensor:
    """Row ``vi`` of a label matrix.  ``mode="gather"`` reads it;
    ``"onehot"`` sums ``onehot(vi) * M`` over the rows, JAX's form for a
    row-sharded matrix (one [L] all-reduce instead of an all-gather); on one
    device both give the same row."""
    if mode == "gather":
        return M[vi]
    onehot = (torch.arange(M.shape[0], device=M.device) == vi).to(M.dtype)
    return (onehot[:, None] * M).sum(0, dtype=M.dtype)


def _append(L: torch.Tensor, lens: torch.Tensor, labeled: torch.Tensor, vi: int):
    """Append ``vi`` at column ``lens[w]`` of every labeled row w (the last
    column on overflow, as JAX writes it); returns (L, lens, overflowed)."""
    l_max = L.shape[1]
    pos = torch.clamp(lens, max=l_max - 1)
    col = torch.arange(l_max, device=L.device)[None, :] == pos[:, None]
    L = torch.where(col & labeled[:, None], torch.full_like(L, vi), L)
    over = (labeled & (lens >= l_max)).any()
    return L, lens + labeled.to(torch.int32), over


def distribute_one(state: LabelState, vi: int, fwd_src: torch.Tensor, fwd_dst: torch.Tensor,
                   rev_src: torch.Tensor, rev_dst: torch.Tensor, n: int, max_steps: int,
                   row_extract: str = "gather") -> LabelState:
    """One iteration of Algorithm 2 (both BFS passes), vectorised."""
    # ---------- reverse pass: vi -> L_out(ancestors) ----------
    lut_in = _membership_lut(n, _dynamic_row(state.L_in, vi, row_extract))
    # pruned[u] = L_out(u) cap L_in(vi) != empty
    pruned_r = lut_in[torch.where(state.L_out == _INVALID, n, state.L_out).long()].any(1)
    visited_r = _masked_reach(vi, pruned_r, rev_src, rev_dst, n, max_steps)
    L_out, out_len, over_r = _append(state.L_out, state.out_len, visited_r & ~pruned_r, vi)

    # ---------- forward pass: vi -> L_in(descendants) ----------
    lut_out = _membership_lut(n, _dynamic_row(L_out, vi, row_extract))
    pruned_f = lut_out[torch.where(state.L_in == _INVALID, n, state.L_in).long()].any(1)
    visited_f = _masked_reach(vi, pruned_f, fwd_src, fwd_dst, n, max_steps)
    L_in, in_len, over_f = _append(state.L_in, state.in_len, visited_f & ~pruned_f, vi)
    return LabelState(L_out=L_out, L_in=L_in, out_len=out_len, in_len=in_len,
                      overflow=state.overflow | over_r | over_f)


def distribution_labeling_torch(
    g: CSRGraph,
    l_max: int = 64,
    order_name: str = "degree_product",
    max_steps: Optional[int] = None,
    device="cuda",
) -> ReachabilityOracle:
    """Full vertex-wise device build (host loop over vertices, a vectorised
    sweep each) on ``device`` (``"cuda"`` by default; ``RuntimeError``
    without a card unless ``device="cpu"``).  Raises ``ValueError`` when a
    label row outgrows ``l_max``."""
    from repro_torch.build.engine import sort_label_rows

    dev = resolve_device(device)
    n = g.n
    order = get_order(g, order_name)

    def edges(h):
        s, d = h.edges()
        return torch.from_numpy(s.astype(np.int64)).to(dev), \
            torch.from_numpy(d.astype(np.int64)).to(dev)

    fwd_src, fwd_dst = edges(g)
    rev_src, rev_dst = edges(g.reverse())
    steps = n if max_steps is None else max_steps

    state = init_state(n, l_max, dev)
    for vi in order:
        state = distribute_one(state, int(vi), fwd_src, fwd_dst, rev_src, rev_dst, n, steps)
    if bool(state.overflow):
        raise ValueError(f"label overflow: some row exceeded l_max={l_max}")
    return ReachabilityOracle(
        L_out=sort_label_rows(state.L_out.cpu().numpy()),
        L_in=sort_label_rows(state.L_in.cpu().numpy()),
        out_len=state.out_len.cpu().numpy(),
        in_len=state.in_len.cpu().numpy(),
    )
