"""Device wave build: Distribution-Labeling's wave sweeps on the card.

The port of ``repro.build.engine_jax`` (``src/repro/build/engine_jax.py``).
The host loop walks the wave schedule (``waves.wave_schedule``); each wave
runs one sweep per direction, and a sweep is the same three steps:

  1. prune:   pruned[u] = OR_{h in L(u)} hop_mask[h]      (gather + OR-fold)
  2. reach:   masked multi-source BFS from the wave members where pruned
              member-bits do not expand                    (K2, ELL OR-gather)
  3. append:  labeled = visited & ~pruned -> rank appends  (segment scatter)

Everything inside a sweep runs on the build's device:

  * frontier expansion is K2 (``kernels.ops.frontier_or``) over the
    degree-sorted neighbor slabs of ``bitset.ell_slabs``, in its fused form:
    each slab ORs straight into the visited words at the slab rows' vertices
    (JAX's ``out_perm[:r] |= part`` then ``out_perm[pos]``), and sets a
    device flag when a word gained a bit.  On a CUDA device that is the
    hand-written kernel; on the CPU its plain version;
  * JAX's ``lax.while_loop`` becomes a Python loop over BFS levels with two
    host reads per level: the size of the needy rows' ``nonzero`` (it picks
    the sparse or the dense prune, JAX's ``lax.cond``) and the K2 flags (the
    fixpoint's "changed" test, and the bad-id check).  One more read per
    sweep fetches the overflow flag;
  * the append runs only over the rows the sweep visited (every other row
    appends nothing), with the ranks scattered into the dense label matrix.
    JAX's ``mode="drop"`` has no torch counterpart, so the label matrices
    carry one parking row (row n) that takes the appends JAX drops, and the
    hop mask two (row n stays zero for INVALID label entries, row n + 1 takes
    the scatter of INVALID member label entries).

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


def _expand_fn(slabs, perm, device):
    """Build the per-level expansion: ``expand(f, out, flags)`` ORs one BFS
    step of every member, from frontier words ``f`` int32[n, wm], into
    ``out`` int32[n, wm] in place (row i of a slab is vertex ``perm[i]``)."""
    slab_t = [torch.from_numpy(np.ascontiguousarray(s)).to(device) for s in slabs]
    perm_t = torch.from_numpy(np.ascontiguousarray(perm, dtype=np.int64)).to(device)

    def expand(f, out, flags):
        for slab in slab_t:
            ops.frontier_or(slab, f, out=out, perm=perm_t[: slab.shape[0]], flags=flags)

    return expand


def _make_wave_step(n, w, l_max, expand, consts, prune_cap=None, counts=None):
    """One direction of Algorithm 2 for a whole wave, on the device.

    ``prune_cap``: prune verdicts are computed lazily per level for the rows
    the BFS just visited — a gather of those rows when they number at most
    ``prune_cap`` (cost tracks cone size, not n), the dense all-rows fold on
    levels that visit more.  The step updates the target label matrix and
    lengths in place and returns ``(overflow, len_prev)``: the pre-wave
    lengths let an overflowing sweep be undone.  ``counts`` (a dict) adds up
    levels and host reads."""
    wm = (w + 31) // 32
    word_all, bit_all, shift_all = consts
    if prune_cap is None:
        prune_cap = max(256, n // 8)
    prune_cap = min(prune_cap, n)

    def wave_step(L_src, L_tgt, len_tgt, members, ranks):
        dev = L_tgt.device
        wlen = members.shape[0]
        word, bit, shift = word_all[:wlen], bit_all[:wlen], shift_all[:wlen]

        # 1. hop_mask[h] = member words of members whose prune row holds h.
        #    Scatter-ADD is exact: each (member, hop) pair is unique, and
        #    distinct members in one word carry distinct bits, so add == OR.
        #    Row n stays zero (INVALID gathers park there); row n + 1 takes
        #    the INVALID entries of the members' rows.
        rows_src = L_src[members]                                   # [wlen, l_max]
        hops = torch.where(rows_src != _INVALID, rows_src, n + 1).long()
        hop_mask = torch.zeros((n + 2, wm), dtype=torch.int32, device=dev)
        hop_mask.index_put_((hops, word[:, None].expand_as(hops)),
                            bit[:, None].expand_as(hops), accumulate=True)

        # 2. fixpoint masked reach.  Verdicts are filled in lazily: each level
        #    computes them for the rows the previous level visited, so the
        #    loop ends only after every visited row has its verdict — the
        #    final level makes no change.
        v = torch.zeros((n, wm), dtype=torch.int32, device=dev)
        v[members, word] = bit
        pruned = torch.zeros((n, wm), dtype=torch.int32, device=dev)
        computed = torch.zeros(n, dtype=torch.bool, device=dev)
        flags = torch.zeros(2, dtype=torch.int32, device=dev)
        visited_rows = []
        tgt_hops = None
        while True:
            need = v.ne(0).any(1) & ~computed
            # host read 1 of the level: nonzero's size (sparse or dense prune)
            idx = need.nonzero().squeeze(1)
            k = idx.shape[0]
            if k:
                visited_rows.append(idx)
                if k <= prune_cap:
                    th = L_tgt[idx]
                    th = torch.where(th != _INVALID, th, n).long()
                    pruned[idx] = or_reduce(hop_mask[th], dim=1)
                else:
                    if tgt_hops is None:  # L_tgt does not change within the fixpoint
                        lt = L_tgt[:n]
                        tgt_hops = torch.where(lt != _INVALID, lt, n).long()
                    verd = or_reduce(hop_mask[tgt_hops], dim=1)
                    pruned = torch.where(need[:, None], verd, pruned)
                computed |= need
            flags.zero_()
            expand(v & ~pruned, v, flags)
            # host read 2 of the level: K2's flags (changed, bad id)
            changed, bad = flags.tolist()
            if counts is not None:
                counts["levels"] += 1
                counts["host_reads"] += 2
            if bad:
                raise RuntimeError("frontier_or met a neighbor id or row outside the graph")
            if not changed:
                break

        # 3. segment-scatter append over the visited rows: member bits ->
        #    (row, len + prefix-popcount) columns.  Appends that JAX drops
        #    (a column at or past l_max) park in row n, column 0.
        len_prev = len_tgt.clone()
        overflow = False
        if visited_rows:
            rows = torch.cat(visited_rows)        # distinct: need excludes computed rows
            lab = v[rows] & ~pruned[rows]         # [k, wm]
            bits = (lab[:, word] >> shift) & 1    # [k, wlen] int32
            prefix = bits.cumsum(1, dtype=torch.int32) - bits
            pos = len_tgt[rows][:, None] + prefix
            on = bits.ne(0)
            fits = on & (pos < l_max)
            r_idx = torch.where(fits, rows[:, None], n)
            c_idx = torch.where(fits, pos, 0).long()
            L_tgt.index_put_((r_idx, c_idx), ranks[None, :].expand_as(pos))
            len_tgt.index_add_(0, rows, bits.sum(1, dtype=torch.int32))
            # the one host read of the sweep: the overflow flag
            overflow = bool((on & ~fits).any())
            if counts is not None:
                counts["host_reads"] += 1
        return overflow, len_prev

    return wave_step


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
) -> ReachabilityOracle:
    """Full device wave build (host loop over waves, device sweeps).

    ``l_max`` is the starting label-matrix width: overflowing sweeps grow it
    geometrically and run again after a watermark undo.  ``prune_cap``
    bounds the per-level sparse prune gather (default max(256, n // 8)).
    ``device`` is where the sweeps run: K2 on a CUDA device, its plain
    version on the CPU.  ``stats_out`` (a dict) receives the counts of
    sweeps, BFS levels, host reads and regrows.

    JAX's ``expand``, ``interpret``, ``block_n``, ``donate`` and ``mesh``
    have no counterpart: which expansion runs is set by where the tensors
    lie, and the sharded expansion is ROADMAP.md Queue 1 item 11."""
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

    # reverse pass expands u -> in-neighbors w (edge w -> u): destination-
    # stationary rows = packed OUT-neighbor slabs; forward pass symmetric
    # with the reverse graph's rows
    perm_out, _, slabs_out = bitset.ell_slabs(
        g.indptr.astype(np.int64), g.indices.astype(np.int64), n, width=ell_width)
    perm_in, _, slabs_in = bitset.ell_slabs(
        g_rev.indptr.astype(np.int64), g_rev.indices.astype(np.int64), n, width=ell_width)

    w = int(max_wave)
    consts = _member_consts(w, dev)
    ex_out = _expand_fn(slabs_out, perm_out, dev)
    ex_in = _expand_fn(slabs_in, perm_in, dev)
    counts = {"sweeps": 0, "levels": 0, "host_reads": 0, "regrows": 0}
    step_rev = step_fwd = None  # rebuilt when l_max grows

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
                    if step_rev is None:
                        step_rev = _make_wave_step(n, w, l_max, ex_out, consts,
                                                   prune_cap=prune_cap, counts=counts)
                        step_fwd = _make_wave_step(n, w, l_max, ex_in, consts,
                                                   prune_cap=prune_cap, counts=counts)
                    counts["sweeps"] += 1
                    if direction == "rev":
                        overflow, len_prev = step_rev(L_in, L_out, out_len, members, ranks)
                    else:
                        overflow, len_prev = step_fwd(L_out, L_in, in_len, members, ranks)
                    if not overflow:
                        break
                    # overflow: watermark-undo the partial appends (they only
                    # wrote columns past the pre-wave lengths), grow the label
                    # matrices, and run this sweep again
                    if ON.enabled:
                        sp.event("overflow_regrow", l_max=l_max * 2)
                    if direction == "rev":
                        _undo(L_out, len_prev)
                        out_len.copy_(len_prev)
                    else:
                        _undo(L_in, len_prev)
                        in_len.copy_(len_prev)
                    pad = torch.full((n + 1, l_max), _INVALID, dtype=torch.int32, device=dev)
                    L_out, L_in = torch.cat([L_out, pad], 1), torch.cat([L_in, pad], 1)
                    l_max *= 2
                    counts["regrows"] += 1
                    step_rev = step_fwd = None
        base += wlen

    if stats_out is not None:
        stats_out.update(counts, device=str(dev), l_max=l_max, member_width=w)
    return ReachabilityOracle(
        L_out=_finalize_side(L_out, out_len, n),
        L_in=_finalize_side(L_in, in_len, n),
        out_len=out_len.cpu().numpy(),
        in_len=in_len.cpu().numpy(),
        hop_rank=_hop_rank(order, n),
    )
