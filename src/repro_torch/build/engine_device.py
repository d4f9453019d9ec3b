"""Device wave build: Distribution-Labeling's wave sweeps on the card.

The port of ``repro.build.engine_jax`` (``src/repro/build/engine_jax.py``).
The host loop walks the wave schedule (``waves.wave_schedule``); each wave
runs one sweep per direction, and a sweep is the same three steps:

  1. prune:   pruned[u] = OR_{h in L(u)} hop_mask[h]      (gather + OR-fold)
  2. reach:   masked multi-source BFS from the wave members where pruned
              member-bits do not expand                    (K2, frontier push)
  3. append:  labeled = visited & ~pruned -> rank appends  (segment scatter)

Everything inside a sweep runs on the build's device, and its cost tracks
the sweep's cone (the rows it reaches), not n:

  * a BFS level is one launch of K2's frontier form
    (``kernels.ops.frontier_expand``): the rows the last level reached push
    the bits they gained over the CSR, compute their prune verdict the first
    time they push, and claim the rows that gain a bit for the next level
    and for the sweep's cone.  On a CUDA device that is the hand-written
    kernel; on the CPU its plain version.  Each bit of a row is pushed once,
    when the row gains it, so every level gives the same visited words as
    JAX's dense level ``v | expand(v & ~pruned)``;
  * JAX's ``lax.while_loop`` becomes a Python loop over BFS levels with one
    host read per level (the ring position, which says whether the level
    claimed a row, the cone length and the bad-id flag) and one per sweep
    (the overflow flag);
  * the append runs over the cone, with the ranks scattered into the dense
    label matrix.  JAX's ``mode="drop"`` has no torch counterpart, so the
    label matrices carry one parking row (row n) that takes the appends JAX
    drops, and the hop mask two (row n stays zero, row n + 1 takes the
    scatter of INVALID member label entries);
  * the state (``_SweepState``) is allocated once per build, and a sweep
    resets only the rows it touched.

With ``mesh=`` the build runs on every rank of a ``DeviceMesh`` (one
process a rank, ``repro_torch.launch.mesh``) as JAX's ``mesh=`` build runs
under ``shard_map``: the waves stay sequential, each BFS level is JAX's
dense level ``v | expand(v & ~pruned)`` with the expansion split by
destination rows over the mesh's data axes (``_MeshExpand``: K2's slab
form ``kernels.ops.frontier_or``, fused, over this rank's share of each ELL
slab of ``bitset.ell_slabs``, then one collective that gathers the row
blocks and ORs the flags), and the hop mask, the verdicts and the append
run alike on every rank.

Packed member words are int32 bit patterns: ``torch.uint32`` lacks ``~``,
``>>`` and ``index_put_(accumulate=True)``.  Bit 31 is the sign bit, so
``(x >> s) & 1`` reads it under an arithmetic shift, and the hop-mask
scatter-add stays exact because the bits added to one word are distinct.

Torch updates in place, so JAX's buffer donation has no counterpart: an
overflowing sweep is undone by masking the columns at or past the pre-wave
lengths back to INVALID, both label matrices double their width, and the
sweep runs again.  The labels come down to numpy once, at finalize, in the
reference builder's byte layout.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.build import bitset
from repro_torch.build.waves import wave_schedule
from repro_torch.core.oracle import ReachabilityOracle, finalize_labels
from repro_torch.core.order import get_order
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph, INVALID
from repro_torch.kernels import ops
from repro_torch.kernels.ref import or_reduce
from repro_torch.obs import trace
from repro_torch.obs.state import ON

_INVALID = int(INVALID)


def _member_consts(w: int, device) -> tuple:
    """(word int64[w], bit int32[w], shift int32[w]): member j lives in word
    j // 32 at bit j % 32 (``bit`` as an int32 bit pattern)."""
    j = np.arange(w)
    bit = (np.uint32(1) << (j % 32).astype(np.uint32)).view(np.int32)
    return (torch.from_numpy(j // 32).to(device),
            torch.from_numpy(bit).to(device),
            torch.from_numpy((j % 32).astype(np.int32)).to(device))


class _SweepState:
    """The sweep's device state, allocated once per build (``wm`` words a
    row).  Between sweeps ``v``, ``delta`` and ``hop_mask`` are zero: a sweep
    resets only the rows it touched.  ``pruned`` keeps old verdicts, which
    the verdict stamps mark as stale.

      v, pruned          int32[n, wm]  visited words and prune verdicts
      delta              int32[2, n, wm]  the bits rows gained in the last
                         level and in this one (``frontier_expand`` clears
                         the first as it reads it, so both are zero again
                         when a sweep ends)
      hop_mask           int32[n + 2, wm]  row n stays zero, row n + 1 takes
                         the members' INVALID label entries
      stamps             int32[3, n]  level claims, verdict sweeps, cone
                         sweeps: ids that only grow, so they need no reset
      frontier           int32[2n]  the ring of level rows
      cone, counts       int32[n], int64[3]  the sweep's distinct rows; the
                         ring position, cone length and bad-id flag

    ``delta``, ``stamps``, ``frontier``, ``cone`` and ``counts`` serve the
    frontier push alone: with ``push=False`` (the mesh build, whose levels
    are dense) they are not allocated."""

    def __init__(self, n: int, w: int, device, push: bool = True):
        wm = (w + 31) // 32
        z = dict(dtype=torch.int32, device=device)
        self.v = torch.zeros((n, wm), **z)
        self.pruned = torch.zeros((n, wm), **z)
        self.hop_mask = torch.zeros((n + 2, wm), **z)
        if push:
            self.delta = torch.zeros((2, n, wm), **z)
            self.deltas = (self.delta[0], self.delta[1])
            self.stamps = torch.full((3, n), -1, **z)
            self.frontier = torch.zeros(2 * n, **z)
            self.cone = torch.zeros(n, **z)
            self.counts = torch.zeros(3, dtype=torch.int64, device=device)
        self.sweep = 0
        self.level = 0
        self.consts = _member_consts(w, device)
        self._bit_rows = {}

    def expander(self, indptr, indices) -> ops.FrontierExpand:
        """``frontier_expand`` bound to this state and the CSR (indptr int64[n
        + 1], indices int32[m]) that a sweep pushes the member bits over."""
        return ops.FrontierExpand(self.frontier, indptr, indices, self.v, self.pruned,
                                  self.hop_mask, self.stamps, self.cone, self.counts)

    def bit_rows(self, l_max: int) -> torch.Tensor:
        """int32[w, l_max]: member j's bit in every column of its row."""
        if l_max not in self._bit_rows:
            bit = self.consts[1]
            self._bit_rows[l_max] = bit[:, None].expand(bit.shape[0], l_max).contiguous()
        return self._bit_rows[l_max]


def _sweep(st: _SweepState, expand: ops.FrontierExpand, L_src, L_tgt, len_tgt, members, ranks,
           counts: dict) -> bool:
    """One direction of Algorithm 2 for a whole wave, on the device.

    ``expand`` pushes the member bits over the sweep's CSR
    (``st.expander``); ``members`` int64[wlen] and ``ranks`` int32[wlen].
    Appends to ``L_tgt`` and ``len_tgt`` in place and returns whether the
    sweep overflowed ``L_tgt``'s width: then ``len_tgt`` still holds the
    pre-wave lengths and the appends it made are undone by ``_undo``.
    ``counts`` adds up levels, host reads and the sweep's cone rows.

    The sweep's torch ops take indices as int64 tensors and scalars as
    kernel arguments (``scatter_``, ``index_fill_``, ``masked_fill_``): an
    ``index_put_`` or a ``torch.where`` with a Python scalar costs host
    syncs, bound checks or a host-to-device copy."""
    n, wm = st.v.shape
    wlen = members.shape[0]
    word, bit, _ = (c[:wlen] for c in st.consts)
    sweep = st.sweep
    st.sweep += 1
    hops = _scatter_hop_mask(st, L_src, members)

    # 2. fixpoint masked reach, a level at a time from the rows the last
    #    level reached.  The members are level 0's frontier and the cone's
    #    first rows; each level is one frontier_expand launch and one host
    #    read (ring position, cone length, bad-id flag), and the fixpoint
    #    ends when a level claims no row.  counts[2] is 0 here: a sweep that
    #    sets it raises.
    flat = members * wm + word
    st.v.view(-1).scatter_(0, flat, bit)
    st.deltas[0].view(-1).scatter_(0, flat, bit)
    st.frontier[:wlen].copy_(members)
    st.cone[:wlen].copy_(members)
    st.stamps[2].index_fill_(0, members, sweep)
    st.counts[:2].fill_(wlen)
    lo, hi, cur = 0, wlen, 0
    while True:
        expand(lo, hi, st.deltas[cur], st.deltas[1 - cur], L_tgt, sweep, st.level)
        st.level += 1
        ring, n_cone, bad = st.counts.tolist()
        counts["levels"] += 1
        counts["host_reads"] += 1
        if bad:
            raise RuntimeError("frontier_expand met a row, neighbor or label id "
                               "outside the graph")
        if ring == hi:
            break
        lo, hi, cur = hi, ring, 1 - cur
    counts["cone_rows"].append(n_cone)
    return _append(st, st.cone[:n_cone].long(), L_tgt, len_tgt, ranks, hops, counts)


def _scatter_hop_mask(st: _SweepState, L_src, members) -> torch.Tensor:
    """Step 1 of a sweep: hop_mask[h] = member words of the members whose
    prune row holds h.  Scatter-ADD is exact: each (member, hop) pair is
    unique, and distinct members in one word carry distinct bits, so add ==
    OR.  Returns the hop ids scattered (INVALID entries parked at row n +
    1), which ``_append`` resets."""
    n, wm = st.v.shape
    l_max = L_src.shape[1]
    wlen = members.shape[0]
    hops = L_src[members].long()                                # [wlen, l_max]
    hops.masked_fill_(hops == _INVALID, n + 1)
    st.hop_mask.view(-1).scatter_add_(0, (hops * wm + st.consts[0][:wlen, None]).view(-1),
                                      st.bit_rows(l_max)[:wlen].view(-1))
    return hops


def _append(st: _SweepState, rows, L_tgt, len_tgt, ranks, hops, counts: dict) -> bool:
    """Steps 3 and 4 of a sweep: the segment-scatter append over ``rows``
    (the sweep's cone: the distinct rows it visited), member bits -> (row,
    len + prefix-popcount) columns, then the state left zero (the cone's
    words and the members' hop rows).  Appends that JAX drops (a column at
    or past l_max) park in row n, column 0.  Returns whether a row
    outgrew ``L_tgt``'s width: then ``len_tgt`` keeps the pre-wave lengths
    and ``_undo`` rolls the appends back."""
    n = st.v.shape[0]
    l_max = L_tgt.shape[1]
    word, _, shift = (c[:ranks.shape[0]] for c in st.consts)
    lab = st.v[rows] & ~st.pruned[rows]       # [k, wm]
    bits = (lab[:, word] >> shift) & 1        # [k, wlen] int32
    cnt = bits.sum(1, dtype=torch.int32)
    ln = len_tgt[rows]
    pos = ln[:, None] + bits.cumsum(1, dtype=torch.int32) - bits
    dst = (rows[:, None] * l_max + pos).masked_fill_((bits == 0) | (pos >= l_max), n * l_max)
    L_tgt.view(-1).scatter_(0, dst.view(-1), ranks.repeat(rows.shape[0]))
    # the one host read of the sweep beside the levels': a row outgrew l_max
    overflow = bool((ln + cnt > l_max).any())
    counts["host_reads"] += 1
    if not overflow:
        len_tgt.index_add_(0, rows, cnt)

    st.v.index_fill_(0, rows, 0)
    st.hop_mask.index_fill_(0, hops.view(-1), 0)
    return overflow


class _MeshExpand:
    """One BFS level of every wave member over a mesh: K2's slab form,
    fused, over this rank's share of each ``bitset.ell_slabs`` slab, then
    the row blocks gathered over the mesh's data axes (the counterpart of
    ``engine_jax._expand_fn`` with ``mesh=``).

    The slabs' rows are permuted by degree, and slab s spans the first r_s
    of them (r_0: every row with a neighbor).  JAX pads each slab to a
    multiple of the data shards and gives shard d the d-th equal block of
    its rows.  Here the blocks of slab 0, ``chunk = ceil(r_0 / shards)``
    rows, are cut once, and shard d takes rows [d * chunk, (d + 1) * chunk)
    of every slab (the padded rows, all INVALID, add nothing and are left
    out).  So each destination row has one owner over all slabs, and a level
    is one collective: the owner ORs the row's slab gathers into its copy
    of the row (``frontier_or``'s fused form, ``perm`` the row's place in
    the block) and the blocks go to every rank by ``gather_rows``, with
    each rank's two flags (a word gained a bit; an id outside the graph)
    riding at the end of its block, so their sum over the gathered blocks
    ORs them.
    The model axis, if any, replicates the work, as in JAX."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, n: int, wm: int,
                 ell_width: int, mesh, device):
        from repro_torch.launch.mesh import axes_except, axis_group

        self.dg = axis_group(mesh, axes_except(mesh))
        perm, _, slabs = bitset.ell_slabs(indptr.astype(np.int64), indices.astype(np.int64),
                                          n, width=ell_width)
        r0 = slabs[0].shape[0] if slabs else 0
        self.wm, self.r0 = wm, r0
        self.chunk = -(-r0 // self.dg.size)
        lo = min(self.dg.index * self.chunk, r0)
        hi = min(lo + self.chunk, r0)
        # this rank's rows of v, the rows every rank scatters the blocks to
        self.own = torch.from_numpy(perm[lo:hi]).to(device)
        self.head = torch.from_numpy(perm[:r0]).to(device)
        self.shares = []
        for slab in slabs:
            top = min(hi, slab.shape[0])
            if top > lo:
                self.shares.append((torch.from_numpy(slab[lo:top]).to(device),
                                    torch.arange(top - lo, dtype=torch.int64, device=device)))
        self.part = torch.zeros((1, self.chunk * wm + 2), dtype=torch.int32, device=device)
        self.block = self.part[0, :self.chunk * wm].view(self.chunk, wm)
        self.flags = self.part[0, self.chunk * wm:]

    def __call__(self, v: torch.Tensor, f: torch.Tensor, counts: dict) -> bool:
        """``v |= expand(f)`` in place on every rank; whether ``v`` gained a
        bit anywhere (the same answer on every rank, so the level loop ends
        on all at once)."""
        from repro_torch.launch.mesh import gather_rows

        self.part.zero_()
        self.block[:self.own.shape[0]] = v[self.own]
        for nbr, at in self.shares:
            ops.frontier_or(nbr, f, self.block, at, self.flags)
            counts["slab_calls"] += 1
        blocks = gather_rows(self.part, self.dg)            # [shards, chunk * wm + 2]
        counts["collectives"] += 1
        v.index_copy_(0, self.head, blocks[:, :self.chunk * self.wm]
                      .reshape(-1, self.wm)[:self.r0])
        gained, bad = blocks[:, self.chunk * self.wm:].sum(0).tolist()
        counts["host_reads"] += 1
        if bad:
            raise RuntimeError("frontier_or met a neighbor id outside the graph")
        return gained > 0


def _sweep_mesh(st: _SweepState, expand: _MeshExpand, L_src, L_tgt, len_tgt, members, ranks,
                counts: dict) -> bool:
    """``_sweep`` over a mesh, mirroring JAX's ``_make_wave_step``: the
    fixpoint masked reach as dense levels ``v |= expand(v & ~pruned)``, each
    split over the data axes by ``expand``, until a level adds no bit.  The
    prune verdicts of every row are computed once, at the start (JAX
    computes them lazily, for the rows each level reaches; a sweep's hop
    mask and target labels do not change, so they are the same).  The rest
    of the sweep runs alike on every rank."""
    n, wm = st.v.shape
    wlen = members.shape[0]
    word, bit, _ = (c[:wlen] for c in st.consts)
    hops = _scatter_hop_mask(st, L_src, members)
    tgt = L_tgt[:n].long()
    tgt.masked_fill_(tgt == _INVALID, n)                # row n of the hop mask is zero
    st.pruned.copy_(or_reduce(st.hop_mask[tgt], dim=1))
    st.v.view(-1).scatter_(0, members * wm + word, bit)
    while True:
        counts["levels"] += 1
        if not expand(st.v, st.v & ~st.pruned, counts):
            break
    rows = st.v.ne(0).any(1).nonzero().squeeze(1)     # a host read: the cone's size
    counts["host_reads"] += 1
    counts["cone_rows"].append(rows.shape[0])
    return _append(st, rows, L_tgt, len_tgt, ranks, hops, counts)


def _undo(L, len_prev):
    """Restore a label matrix to its pre-wave watermark in place (JAX's
    ``_make_undo``): appends only ever write columns >= the old row length
    (which held INVALID), so masking those columns back to INVALID is an
    exact rollback."""
    n = len_prev.shape[0]
    cols = torch.arange(L.shape[1], dtype=torch.int32, device=L.device)[None, :]
    L[:n].masked_fill_(cols >= len_prev[:, None], _INVALID)


def certification_mask(labeled_rev, visited_rev, labeled_fwd, visited_fwd, members, w):
    """Device mirror of ``bitset.violation_mask`` — which members of an
    optimistic wave ran on stale prune sets.

    Inputs are the two sweeps' end-of-wave masks as int32[n, ceil(w/32)]
    bit patterns (``labeled`` = ``visited & ~pruned``), plus the wave's
    member vertex ids.  Member j is bit j in both directions, so member j's
    reverse sweep is violated when some lower-ranked wave-mate i both
    appended into L_in(v_j) (``labeled_fwd[members][j]`` bit i) and labeled
    a row the reverse sweep visited (touch matrix of ``visited_rev`` /
    ``labeled_rev``); forward is symmetric.  Returns bool[w].  The speculative
    engine (a later slice) adopts device waves through it."""
    dev = labeled_rev.device
    word, _, shift = _member_consts(w, dev)
    jj = np.arange(w)
    pref_bool = jj[None, :] < jj[:, None]  # triangular prefix masks (bits < j)
    pref = torch.from_numpy(bitset.pack_bool_rows_u32(pref_bool).view(np.int32)).to(dev)
    members = torch.as_tensor(np.asarray(members), device=dev).long()

    def unpack(m):  # int32[n, wm] -> bool[n, w]
        return ((m[:, word] >> shift) & 1).bool()

    def touch(v_mask, a_mask):  # T[j] = OR of a_mask rows with v-bit j set
        vb = unpack(v_mask)
        return or_reduce(torch.where(vb[:, :, None], a_mask[:, None, :], 0), dim=0)

    own_rev = labeled_rev[members] & pref
    own_fwd = labeled_fwd[members] & pref
    t_rev = touch(visited_rev, labeled_rev)
    t_fwd = touch(visited_fwd, labeled_fwd)
    return ((own_fwd & t_rev) | (own_rev & t_fwd)).ne(0).any(1)


def _finalize_side(L, lens, n) -> np.ndarray:
    """Device label matrix -> the reference builder's byte layout (rows
    ascending, INVALID padded, width = next multiple of 8, min 8)."""
    from repro_torch.build.engine import sort_label_rows

    lens = lens.cpu().numpy()
    lmax = int(lens.max()) if n else 1
    width = max(((max(lmax, 1) + 7) // 8) * 8, 8)
    mat = L[:n, :width].cpu().numpy()
    if mat.shape[1] < width:  # small l_max that never overflowed: pad out
        pad = np.full((mat.shape[0], width - mat.shape[1]), INVALID, dtype=np.int32)
        mat = np.concatenate([mat, pad], axis=1)
    return sort_label_rows(mat)


def distribution_labeling_device(
    g: CSRGraph,
    order: Optional[np.ndarray] = None,
    order_name: str = "degree_product",
    max_wave: int = 64,
    l_max: int = 16,
    ell_width: int = 16,
    waves: Optional[np.ndarray] = None,
    prune_cap: Optional[int] = None,
    device="cuda",
    stats_out: Optional[dict] = None,
    mesh=None,
) -> ReachabilityOracle:
    """Full device wave build (host loop over waves, device sweeps).

    ``l_max`` is the starting label-matrix width: overflowing sweeps grow it
    geometrically and run again after a watermark undo.  ``device`` is where
    the sweeps run: the kernels on a CUDA device, their plain versions on
    the CPU.  ``stats_out`` (a dict) receives the counts of sweeps, BFS
    levels, host reads and regrows, and the cone rows a sweep.

    Without ``mesh`` a level pushes from the rows the last level reached
    (``frontier_expand``).  With ``mesh`` (a ``DeviceMesh`` from
    ``repro_torch.launch.mesh``; every rank of it calls this with the same
    graph) the waves stay sequential and each level is JAX's dense level,
    its slab expansion split by destination rows over the mesh's data
    axes (``_MeshExpand``: ``frontier_or`` on this rank's share of each
    ``ell_width`` slab, one collective a level); the rest of the sweep runs
    alike on every rank, and every rank returns the same labels.
    ``stats_out`` then also counts the slab calls and the collectives.

    ``prune_cap`` keeps JAX's signature and changes nothing: every verdict
    is computed once a sweep (for the rows a level claimed, or for every
    row under a mesh), where JAX picks per level between a gather of at
    most ``prune_cap`` rows and a dense fold.  ``ell_width`` sets the
    slabs of the mesh build; the push reads the CSR.  JAX's ``expand``,
    ``interpret``, ``block_n`` and ``donate`` have no counterpart: which
    expansion runs is set by ``mesh`` and by where the tensors lie."""
    from repro_torch.build.engine import _hop_rank

    dev = resolve_device(device)
    n = g.n
    if n == 0:
        return finalize_labels([], [], hop_rank=np.empty(0, dtype=np.int32))
    if order is None:
        order = get_order(g, order_name)
    order = np.asarray(order, dtype=np.int64)
    if waves is None:
        waves = wave_schedule(g, order, max_wave=max_wave)
    # the member width follows the ACTUAL schedule (a caller may hand in
    # waves cut at a different cap), rounded to whole 32-bit words
    max_wave = int(max(int(np.max(waves)) if waves.size else 1, 1))
    max_wave = ((max_wave + 31) // 32) * 32 if max_wave > 32 else max_wave
    g_rev = g.reverse()

    # the reverse sweep pushes a row's bits to its in-neighbors (the
    # reverse graph's CSR), the forward sweep to its out-neighbors
    def csr(h):
        return (torch.from_numpy(np.ascontiguousarray(h.indptr, dtype=np.int64)).to(dev),
                torch.from_numpy(np.ascontiguousarray(h.indices, dtype=np.int32)).to(dev))

    w = int(max_wave)
    st = _SweepState(n, w, dev, push=mesh is None)
    counts = {"sweeps": 0, "levels": 0, "host_reads": 0, "regrows": 0, "cone_rows": []}
    if mesh is None:
        sweep = _sweep
        ex_rev, ex_fwd = st.expander(*csr(g_rev)), st.expander(*csr(g))
    else:
        # the reverse sweep gathers a row's bits from its out-neighbors (the
        # graph's slabs), the forward sweep from its in-neighbors
        sweep = _sweep_mesh
        wm = (w + 31) // 32
        ex_rev = _MeshExpand(g.indptr, g.indices, n, wm, ell_width, mesh, dev)
        ex_fwd = _MeshExpand(g_rev.indptr, g_rev.indices, n, wm, ell_width, mesh, dev)
        counts.update(slab_calls=0, collectives=0)

    # row n of each label matrix parks the appends JAX drops
    L_out = torch.full((n + 1, l_max), _INVALID, dtype=torch.int32, device=dev)
    L_in = torch.full((n + 1, l_max), _INVALID, dtype=torch.int32, device=dev)
    out_len = torch.zeros(n, dtype=torch.int32, device=dev)
    in_len = torch.zeros(n, dtype=torch.int32, device=dev)
    order_t = torch.from_numpy(order).to(dev)
    ranks_t = torch.arange(n, dtype=torch.int32, device=dev)

    base = 0
    for wi, wlen in enumerate(waves):
        wlen = int(wlen)
        sp = (trace.span("build.wave", cat="build",
                         args={"index": wi, "size": wlen}, annotate=True)
              if ON.enabled else trace.NOOP_SPAN)
        with sp:
            members = order_t[base: base + wlen]
            ranks = ranks_t[base: base + wlen]
            # reverse then forward: the forward prune set L_out(v_j) must see
            # the member's own rank, which the reverse sweep just appended
            for direction in ("rev", "fwd"):
                while True:
                    counts["sweeps"] += 1
                    if direction == "rev":
                        overflow = sweep(st, ex_rev, L_in, L_out, out_len, members, ranks,
                                         counts)
                    else:
                        overflow = sweep(st, ex_fwd, L_out, L_in, in_len, members, ranks,
                                         counts)
                    if not overflow:
                        break
                    # overflow: watermark-undo the partial appends (they only
                    # wrote columns past the pre-wave lengths, which the
                    # overflowing sweep left as they were), grow the label
                    # matrices, and run this sweep again
                    if ON.enabled:
                        sp.event("overflow_regrow", l_max=l_max * 2)
                    if direction == "rev":
                        _undo(L_out, out_len)
                    else:
                        _undo(L_in, in_len)
                    pad = torch.full((n + 1, l_max), _INVALID, dtype=torch.int32, device=dev)
                    L_out, L_in = torch.cat([L_out, pad], 1), torch.cat([L_in, pad], 1)
                    l_max *= 2
                    counts["regrows"] += 1
        base += wlen

    if stats_out is not None:
        cone = np.asarray(counts.pop("cone_rows"), dtype=np.int64)
        stats_out.update(counts, device=str(dev), l_max=l_max, member_width=w,
                         cone_rows_mean=float(cone.mean()) if cone.size else 0.0,
                         cone_rows_p99=float(np.percentile(cone, 99)) if cone.size else 0.0,
                         cone_rows_max=int(cone.max()) if cone.size else 0)
    return ReachabilityOracle(
        L_out=_finalize_side(L_out, out_len, n),
        L_in=_finalize_side(L_in, in_len, n),
        out_len=out_len.cpu().numpy(),
        in_len=in_len.cpu().numpy(),
        hop_rank=_hop_rank(order, n),
    )
