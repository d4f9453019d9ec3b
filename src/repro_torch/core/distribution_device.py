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
.engine_device``.

``make_sharded_distribute_one`` is the same iteration over a
vertex-partitioned state, one process a rank: the program of one rank of
the ``build_sweep`` cells (``configs.reachability``), whose layout is
JAX's.  Label rows and lengths lie with their vertex block on the mesh's
data axes, the four edge arrays are split evenly over them, ``overflow``
and ``vi`` are on every rank.  A BFS step packs this rank's frontier rows
to int32 words and all-gathers them, ORs the hits of this rank's edges
into an n-wide uint8 partial and reduces the partials onto the owners'
rows (``reduce_scatter_tensor`` MAX), then reduces a "changed" flag over
the data axes.  ``vi``'s label row reaches every rank by one [L]
all-reduce (``row_extract="onehot"``) or an all-gather of the matrix
(``"gather"``, what JAX's SPMD does for ``M[vi]``).  The prune test and the
append stay local.  ``build_sweep_specs`` gives the cells' global shapes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.cell import TensorSpec
from repro_torch.core.oracle import ReachabilityOracle
from repro_torch.core.order import get_order
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph, INVALID
from repro_torch.launch.mesh import gather_rows, or_over, sum_over

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


# ------------------------------------------------------- vertex-partitioned


def build_sweep_specs(n: int, m: int, l_max: int) -> dict:
    """The global ``TensorSpec``s of ``distribute_one``'s arguments at
    production scale (JAX's ``build_sweep_specs``; no allocation)."""
    i32 = torch.int32
    state = LabelState(
        L_out=TensorSpec((n, l_max), i32),
        L_in=TensorSpec((n, l_max), i32),
        out_len=TensorSpec((n,), i32),
        in_len=TensorSpec((n,), i32),
        overflow=TensorSpec((), torch.bool),
    )
    return dict(state=state, vi=TensorSpec((), i32), fwd_src=TensorSpec((m,), i32),
                fwd_dst=TensorSpec((m,), i32), rev_src=TensorSpec((m,), i32),
                rev_dst=TensorSpec((m,), i32))


class _Rows:
    """This rank's vertex block on the data group ``ag``: rows
    [offset, offset + n_local) of every row-sharded array.  The exchanges
    skip the collective on a group of one (the single-device program)."""

    def __init__(self, ag, n: int, n_local: int):
        self.ag, self.n, self.n_local = ag, n, n_local
        self.offset = ag.index * n_local
        self.words = (n_local + 31) // 32   # a rank's packed frontier words

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        return part if self.ag.size == 1 else gather_rows(part, self.ag)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return sum_over(t, self.ag)

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        return flag if self.ag.size == 1 else or_over(flag, self.ag)

    def reduce_max(self, partial: torch.Tensor) -> torch.Tensor:
        """The max over the ranks of a uint8[n] partial, this rank keeping
        its own block (``reduce_scatter_tensor`` MAX)."""
        if self.ag.size == 1:
            return partial
        out = torch.empty(self.n_local, dtype=partial.dtype, device=partial.device)
        dist.reduce_scatter_tensor(out, partial, op=dist.ReduceOp.MAX, group=self.ag.group)
        return out

    def row(self, M: torch.Tensor, vi: torch.Tensor, mode: str) -> torch.Tensor:
        """Row ``vi`` of the row-sharded ``M`` on every rank."""
        if mode == "gather":
            return self.gather(M).index_select(0, vi.reshape(1).long())[0]
        if mode != "onehot":
            raise ValueError(f"row_extract must be 'gather' or 'onehot', got {mode!r}")
        local = vi.long() - self.offset
        onehot = (torch.arange(M.shape[0], device=M.device) == local).to(M.dtype)
        return self.sum((onehot[:, None] * M).sum(0, dtype=M.dtype))


def _pack_words(bits: torch.Tensor, words: int) -> torch.Tensor:
    """bool[k] -> int32[words] bit patterns, bit j of word w is entry 32w + j."""
    pad = torch.zeros(words * 32, dtype=torch.int32, device=bits.device)
    pad[:bits.shape[0]] = bits.to(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    # distinct bits: their int32 sum is their OR, bit 31 included
    return (pad.view(words, 32) << shifts).sum(1, dtype=torch.int32)


def _sharded_reach(rows: _Rows, vi: torch.Tensor, pruned: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, max_steps: int, host_read: bool) -> torch.Tensor:
    """bool[n_local]: this rank's rows of ``_masked_reach``'s visited set,
    ``src``/``dst`` this rank's int32 edges.  Without ``host_read`` (meta
    tensors: no data to stop on) it runs all ``max_steps`` steps."""
    dev = pruned.device
    visited = (torch.arange(rows.n_local, device=dev) + rows.offset) == vi.long()
    # where each edge's source bit lies among the gathered words
    owner = torch.div(src, rows.n_local, rounding_mode="floor")
    j = src - owner * rows.n_local
    word = owner * rows.words + (j >> 5)
    bit = j & 31
    for _ in range(max_steps):
        words = rows.gather(_pack_words(visited & ~pruned, rows.words))
        active = (words.index_select(0, word) >> bit) & 1
        hits = torch.zeros(rows.n, dtype=torch.int32, device=dev).index_add_(0, dst, active)
        hit = rows.reduce_max((hits > 0).to(torch.uint8)).bool()
        new = visited | hit
        changed = rows.any((new != visited).any().reshape(1))
        visited = new
        if host_read and not bool(changed):
            break
    return visited


def _sharded_pass(rows: _Rows, L: torch.Tensor, lens: torch.Tensor, L_other: torch.Tensor,
                  vi: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, max_steps: int,
                  row_extract: str, host_read: bool) -> tuple:
    """One BFS pass of ``distribute_one`` on this rank's rows: the prune test
    against ``vi``'s row of ``L_other``, the masked reach and the append of
    ``vi`` into ``L``; returns (L, lens, this rank's overflow flag)."""
    n = rows.n
    lut = _membership_lut(n, rows.row(L_other, vi, row_extract))
    # pruned[w] = L(w) cap row(vi) != empty, looked up through int32 ids
    ids = torch.where(L == _INVALID, n, L)
    pruned = lut.index_select(0, ids.reshape(-1)).view(L.shape).any(1)
    del ids
    labeled = _sharded_reach(rows, vi, pruned, src, dst, max_steps, host_read) & ~pruned
    l_max = L.shape[1]
    pos = torch.clamp(lens, max=l_max - 1)
    col = torch.arange(l_max, device=L.device)[None, :] == pos[:, None]
    L = torch.where(col & labeled[:, None], vi.to(L.dtype), L)
    over = (labeled & (lens >= l_max)).any()
    return L, lens + labeled.to(torch.int32), over


def make_sharded_distribute_one(mesh, n: int, max_steps: int, row_extract: str = "gather"):
    """One rank's ``distribute_one`` over a vertex-partitioned state on
    ``mesh``'s data axes (``None``: one rank, the single-device program).

    ``fn(state, vi, fwd_src, fwd_dst, rev_src, rev_dst) -> state``: ``state``
    a ``LabelState`` of this rank's rows (n / P of them, P the data axes'
    ranks; ``overflow`` the same on every rank), ``vi`` a 0-d int32 tensor,
    the edges int32[m / P], this rank's block of each edge array split
    evenly.  Returns this rank's rows of one-process ``distribute_one``'s
    state, exactly, and the same ``overflow`` on every rank.  Each BFS step
    reads its "changed" flag on the host; on ``meta`` tensors (a dry run)
    every pass runs ``max_steps`` steps.  Collective: every rank calls it."""
    from repro_torch.configs.cell import data_axes_of
    from repro_torch.launch.mesh import ONE_RANK, axis_group

    ag = ONE_RANK if mesh is None else axis_group(mesh, data_axes_of(mesh))

    def fn(state: LabelState, vi, fwd_src, fwd_dst, rev_src, rev_dst) -> LabelState:
        n_local = state.L_out.shape[0]
        if n_local * ag.size != n:
            raise ValueError(f"{n_local} rows a rank x {ag.size} ranks is not n = {n}")
        rows = _Rows(ag, n, n_local)
        vi = torch.as_tensor(vi, dtype=torch.int32, device=state.L_out.device)
        host_read = state.L_out.device.type != "meta"
        L_out, out_len, over_r = _sharded_pass(rows, state.L_out, state.out_len, state.L_in,
                                               vi, rev_src, rev_dst, max_steps, row_extract,
                                               host_read)
        L_in, in_len, over_f = _sharded_pass(rows, state.L_in, state.in_len, L_out, vi,
                                             fwd_src, fwd_dst, max_steps, row_extract,
                                             host_read)
        over = rows.any((over_r | over_f).reshape(1))[0]
        return LabelState(L_out=L_out, L_in=L_in, out_len=out_len, in_len=in_len,
                          overflow=state.overflow | over)

    return fn
