"""Packed-bitset utilities for the construction engine.

The wave engine represents per-wave BFS state as *member masks*: K = ceil(W/64)
uint64 words per vertex whose bit j says "wave member j".  Frontiers, visited
sets, prune verdicts, and the per-hop label-membership table are all arrays of
such words, so every Algorithm-2 prune test collapses to word-wide AND/OR over
contiguous numpy memory.  This module holds the word-level primitives; the
sweep logic lives in ``engine_device.py`` (and the host batched engines, a
later slice of the port).

A copy of ``repro.build.bitset`` (numpy only), held equal to it in
``tests/test_torch_waves.py``: the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_U1 = np.uint64(1)
_SHIFTS = np.arange(64, dtype=np.uint64)

if hasattr(np, "bitwise_count"):  # numpy >= 2.0
    def _popcount(x: np.ndarray) -> np.ndarray:
        return np.bitwise_count(x).astype(np.int64)
else:  # SWAR fallback for older numpy
    def _popcount(x: np.ndarray) -> np.ndarray:
        x = x.astype(np.uint64)
        x = x - ((x >> _U1) & np.uint64(0x5555555555555555))
        x = (x & np.uint64(0x3333333333333333)) + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333))
        x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(np.int64)


def popcount_u64(x: np.ndarray) -> np.ndarray:
    """Population count; multi-word mask rows ([..., K]) sum over words."""
    p = _popcount(x)
    return p.sum(axis=-1) if p.ndim > 1 else p


def n_words(width: int) -> int:
    """uint64 words needed for ``width`` member bits."""
    return max((width + 63) // 64, 1)


def member_bits(width: int, k: int | None = None) -> np.ndarray:
    """uint64[width, k] — row j holds the one-hot mask of member j.  ``k``
    defaults to the minimum word count; pass the scratch arrays' word count
    so masks align with preallocated state."""
    if k is None:
        k = n_words(width)
    bits = np.zeros((width, k), dtype=np.uint64)
    j = np.arange(width)
    bits[j, j // 64] = _U1 << (j % 64).astype(np.uint64)
    return bits


def expand_member_bits(
    bits: np.ndarray, width: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unpack member-mask rows into (row, member, counts) index arrays.

    bits: uint64[k, K] -> (row int64[t], member int64[t], counts int64[k])
    listing every set bit, row-major: all members of bits[0] first
    (ascending member), then bits[1]…

    Most rows carry a single bit (one member labels the vertex), so those go
    through an arithmetic fast path; only multi-bit rows pay for the dense
    bit table.
    """
    counts = popcount_u64(bits)
    if int(counts.max(initial=0)) <= 1:
        rows = np.flatnonzero(counts)
        return rows, _single_bit_members(bits[rows]), counts
    single = counts == 1
    multi = ~single & (counts > 0)
    rows_s = np.flatnonzero(single)
    mem_s = _single_bit_members(bits[rows_s])
    rows_m = np.flatnonzero(multi)
    sub = bits[rows_m]
    table = (sub[:, :, None] >> _SHIFTS[None, None, :]) & _U1
    r_m, mem_m = np.nonzero(table.reshape(sub.shape[0], -1)[:, :width])
    # merge, keeping row-major order (each row is single xor multi, and the
    # stable sort preserves the ascending member order within a row)
    rows = np.concatenate([rows_s, rows_m[r_m]])
    members = np.concatenate([mem_s, mem_m.astype(np.int64)])
    order = np.argsort(rows, kind="stable")
    return rows[order], members[order], counts


def _single_bit_members(sub: np.ndarray) -> np.ndarray:
    """member index of each single-bit mask row: uint64[r, K] -> int64[r]."""
    if sub.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    word = np.argmax(sub != 0, axis=1)
    val = sub[np.arange(sub.shape[0]), word]
    return word * 64 + _popcount(val - _U1)


def prefix_bits(width: int, k: int | None = None) -> np.ndarray:
    """uint64[width, k] — row j holds the mask of members i < j.

    The triangular prefix masks the speculative certification pass ANDs
    against: a violation of member j can only come from a *lower-ranked*
    wave-mate, so every candidate mask is clipped to bits < j before the
    touch-matrix intersection."""
    if k is None:
        k = n_words(width)
    j = np.arange(width)
    out = np.zeros((width, k), dtype=np.uint64)
    w_idx = j // 64
    out[np.arange(k)[None, :] < w_idx[:, None]] = np.uint64(0xFFFFFFFFFFFFFFFF)
    rem = (j % 64).astype(np.uint64)
    out[j, w_idx] = (_U1 << rem) - _U1
    return out


def touch_matrix(v_bits: np.ndarray, a_bits: np.ndarray, width: int) -> np.ndarray:
    """uint64[width, K] — row j = OR of ``a_bits`` rows whose ``v_bits`` row
    has member bit j set.

    This is the label-touched-rows aggregation of the certification pass:
    with ``v_bits`` and ``a_bits`` both = appended-label masks of the same
    store rows (``v_bits`` pre-masked to the victim members), row j collects
    *which members appended a label at some row member j labeled* — the left
    operand of the violation intersection.  Cost tracks the set bits of
    ``v_bits``, so callers should pre-mask ``v_bits`` down to the member
    bits they actually need."""
    K = a_bits.shape[1]
    out = np.zeros((width, K), dtype=np.uint64)
    if v_bits.shape[0] == 0:
        return out
    rows, members, _ = expand_member_bits(v_bits, width)
    if rows.shape[0] == 0:
        return out
    keys, orw = group_or(members, a_bits[rows])
    out[keys] = orw
    return out


def violation_mask(
    own_rev: np.ndarray,
    own_fwd: np.ndarray,
    touch_rev: np.ndarray,
    touch_fwd: np.ndarray,
    sides: bool = False,
) -> np.ndarray:
    """bool[w] — which members of a speculative wave ran on stale prune sets.

    All four operands are bank-local uint64[w, Kr] masks over the wave's w
    members.  ``own_rev[j]`` / ``own_fwd[j]`` say which wave-mates appended
    into member j's own prune-source rows (L_out(v_j) / L_in(v_j)) during
    the speculative sweep; ``touch_rev[j]`` / ``touch_fwd[j]`` say which
    wave-mates appended at rows member j's reverse/forward sweep also
    labeled (``touch_matrix``).  Member j's reverse sweep is violated when
    some lower-ranked i both entered L_in(v_j) (its prune set was stale)
    and labeled a row the sweep labeled (the staleness changed a verdict);
    the forward case is symmetric.  Because the speculative sweep
    *over*-labels relative to the sequential loop (its wave-start prune
    sets are subsets of the sequential ones), the mask is exact: every true
    sequential divergence is flagged, and a member pruned at a touched row
    anyway is not.

    With ``sides=True`` returns the pair (viol_rev, viol_fwd) instead of
    their union — violations are per-sweep, so a member stale on one side
    only needs that side rolled back and replayed."""
    w = own_rev.shape[0]
    pref = prefix_bits(w, own_rev.shape[1])
    viol_rev = ((own_fwd & pref) & touch_rev).any(axis=1)
    viol_fwd = ((own_rev & pref) & touch_fwd).any(axis=1)
    if sides:
        return viol_rev, viol_fwd
    return viol_rev | viol_fwd


def masks_to_matrix(masks: np.ndarray, width: int) -> np.ndarray:
    """uint64[r, K] member masks -> bool[r, width] membership matrix."""
    table = (masks[:, :, None] >> _SHIFTS[None, None, :]) & _U1
    return table.reshape(masks.shape[0], -1)[:, :width].astype(bool)


def group_or(keys: np.ndarray, words: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """OR-combine mask rows that share a key: the scatter-OR of a frontier.

    keys int64[t], words uint64[t, K] -> (unique_keys_sorted, or_of_rows).
    This is how duplicate BFS edge hits and shared hops merge without
    np.ufunc.at.
    """
    if keys.size == 0:
        return keys, words
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    sw = words[order]
    starts = np.flatnonzero(np.concatenate(([True], sk[1:] != sk[:-1])))
    return sk[starts], np.bitwise_or.reduceat(sw, starts, axis=0)


def csr_gather(
    indptr: np.ndarray, indices: np.ndarray, verts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate the CSR neighbor lists of ``verts`` in one shot.

    Returns (neighbors, seg) where seg[k] is the position in ``verts`` whose
    adjacency produced neighbors[k] — the vectorized multi-source frontier
    expansion used by every wave sweep.
    """
    starts = indptr[verts]
    counts = indptr[verts + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=indices.dtype), np.empty(0, dtype=np.int64)
    cum = np.cumsum(counts)
    offs = np.repeat(starts - (cum - counts), counts) + np.arange(total, dtype=np.int64)
    seg = np.repeat(np.arange(verts.shape[0], dtype=np.int64), counts)
    return indices[offs], seg


def pack_bool_rows_u32(mat: np.ndarray) -> np.ndarray:
    """bool[n, k] -> uint32[n, ceil(k/32)] with bit (j % 32) of word (j // 32)
    set iff mat[i, j] — the packed member-word layout of ``engine_device.py``."""
    n, k = mat.shape
    words = (k + 31) // 32
    padded = np.zeros((n, words * 32), dtype=bool)
    padded[:, :k] = mat
    bit = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, None, :]
    return (padded.reshape(n, words, 32).astype(np.uint32) * bit).sum(axis=2, dtype=np.uint32)


def ell_slabs(
    indptr: np.ndarray, indices: np.ndarray, n: int, width: int = 16
) -> Tuple[np.ndarray, np.ndarray, list]:
    """Degree-sorted ELL slab decomposition of a CSR adjacency.

    Rows are permuted by degree descending, then neighbor lists are cut into
    fixed-``width`` column slabs: slab s holds neighbor slots
    [s*width, (s+1)*width) and only spans the first r_s permuted rows (those
    with degree > s*width), so total slot count is O(m + n*width) — never
    the dense n x n bits the old device demonstrator materialized.  Skewed
    degree distributions cost extra slabs over a FEW rows instead of forcing
    every row to hub width.

    Returns (perm, pos_of, slabs): ``perm`` int64[n] degree-sorted vertex
    ids, ``pos_of`` its inverse (vertex -> permuted row), ``slabs`` a list
    of INVALID-padded int32[r_s, width] neighbor-id arrays whose row i holds
    slots of vertex perm[i].
    """
    deg = np.diff(indptr).astype(np.int64)
    perm = np.argsort(-deg, kind="stable").astype(np.int64)
    pos_of = np.empty(n, dtype=np.int64)
    pos_of[perm] = np.arange(n, dtype=np.int64)
    sdeg = deg[perm]
    starts = indptr[perm].astype(np.int64)
    max_deg = int(sdeg[0]) if n else 0
    slabs = []
    s = 0
    while s * width < max_deg:
        r = int(np.searchsorted(-sdeg, -(s * width), side="left"))
        r = max(r, 1)
        take = np.minimum(np.maximum(sdeg[:r] - s * width, 0), width)
        slab = np.full((r, width), -1, dtype=np.int32)
        cols = np.arange(width, dtype=np.int64)[None, :]
        in_row = cols < take[:, None]
        offs = starts[:r, None] + s * width + cols
        slab[in_row] = indices[offs[in_row]]
        slabs.append(slab)
        s += 1
    return perm, pos_of, slabs


