"""K4's float32 short-row kernel on the CPU: its plan and its merge.

On the card, a (batch, kv head) with fewer than 64 packed query rows runs
``csrc/flash_attention.cu``'s short-row kernel: the keys some row of a block
can see are cut into ``splits`` pieces of whole 32-key chunks, a block a
piece, and a second launch merges the pieces' partial softmaxes.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``); here:

  * the plan (``ops.attention_split_plan``, ``ops.attention_pieces``): on
    every row tile the pieces are contiguous, chunk-aligned and cover the
    keys the tile's rows can see exactly once, for causal and windowed rows,
    kv_len < T, S > 1 short rows and rows that see no key; a grid whose row
    tiles already give each of the card's 132 SMs a block takes one piece;
  * the merge, through a plain-torch mirror of the kernel's plan
    (``library_cases.split_partials`` / ``merge_partials``: each piece's
    base-2 (m, l, o), weighted by 2^(m - M)), against
    ``ref.flash_attention_ref`` within 1e-6 (rtol and atol: the mirror in
    float64, the plain version in float32, whose own rounding reaches 1.2e-6
    of the largest |value| at D = 128) and against the JAX package on the
    filled prefix (``T = kv_len``) within 1e-5:
    ``repro.kernels.ops.flash_attention`` in interpret mode where v is as
    wide as q and k, ``repro.models.transformer._attention_scores`` (what
    MLA calls; the Pallas kernel ties v's width to D) at (192, 128);
  * its controls: a merge that drops one piece holding keys, or that weighs
    a piece without keys as if it held some (a stale partial left in the
    workspace), fails that bound.

Inputs are made from a seed with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from library_cases import (SPLIT_CASES, case_id, make_kv_len_case, merge_partials,
                           split_partials)
from repro.kernels import ops as jops
from repro.models.transformer import _attention_scores
from repro_torch.kernels import ops, ref

MIRROR_TOL = 1e-6
JAX_TOL = 1e-5

# (B, Hkv, rep, S, kv_len, causal, window): the plan's cases: danube's decode
# over a rank's 4,096 keys, its windows (2,287; one key; a piece's first key
# and one key either side), kv_len 4,161 and 4,097, rep 1 and 8, S = 15 at
# rep 4, with windows and without causal, rows that see no key (S > kv_len,
# window 0), rep 1 S = 60 (tiles of unequal length: whole pieces empty),
# 64 rows (the tiled kernel), grids of 256 and 132 blocks unsplit
PLAN_CASES = [(1, 8, 4, 1, 4096, True, None), (1, 8, 4, 1, 4096, True, 2287),
              (1, 8, 4, 1, 4000, True, 1), (1, 8, 4, 1, 4096, True, 2048),
              (1, 8, 4, 1, 4096, True, 2047), (1, 8, 4, 1, 4096, True, 2049),
              (1, 8, 4, 1, 4161, True, None), (2, 8, 4, 1, 4097, True, None),
              (1, 8, 1, 1, 4096, True, None), (1, 2, 8, 1, 4097, True, None),
              (1, 8, 4, 15, 4096, True, None), (1, 8, 4, 15, 4161, True, 700),
              (1, 2, 4, 15, 4096, False, 300), (1, 8, 4, 15, 10, True, None),
              (1, 2, 4, 3, 500, True, 0), (1, 1, 1, 60, 300, True, None),
              (1, 1, 1, 60, 3000, False, 1000), (1, 2, 3, 7, 999, True, 400),
              (1, 2, 8, 8, 4096, True, None), (8, 32, 1, 1, 4161, True, None),
              (4, 33, 1, 1, 4096, True, None), (1, 1, 4, 1, 33, True, None)]

# (B, Hq, Hkv, S, T, kv_len, D, Dv, causal, window): the mirror's cases, small
# enough for the JAX package's interpret mode: rep 1, 4 and 8; D 64, 80 and
# 128, and (192, 128); kv_len < T (NaN past it); a window of one key; windows
# that leave whole pieces empty for some rows of a tile (S = 60 at rep 1,
# S = 40 with a window, no causal); rows that see no key (S > kv_len)
MIRROR_CASES = [(1, 2, 2, 1, 300, 300, 64, 64, True, None),
                (1, 8, 2, 1, 300, 257, 80, 80, True, None),
                (1, 16, 2, 1, 400, 400, 128, 128, True, None),
                (2, 8, 2, 1, 600, 555, 80, 80, True, 300),
                (1, 8, 2, 1, 300, 300, 80, 80, True, 1),
                (1, 4, 1, 15, 300, 300, 64, 64, True, None),
                (1, 4, 1, 15, 300, 10, 64, 64, True, None),
                (1, 1, 1, 60, 300, 300, 64, 64, True, None),
                (1, 2, 2, 40, 700, 700, 80, 80, True, 150),
                (1, 1, 1, 60, 900, 800, 64, 64, False, 400),
                (1, 2, 2, 1, 300, 300, 192, 128, True, None),
                (1, 4, 4, 30, 500, 480, 192, 128, False, 200)]


def _close(got, exp, tol):
    return torch.allclose(got.double(), exp.double(), rtol=tol, atol=tol)


def _inputs(rng, case):
    B, Hq, Hkv, S, T, kv_len, D, Dv, causal, window = case
    q, k, v = (torch.from_numpy(x) for x in make_kv_len_case(rng, B, Hq, Hkv, S, T, kv_len,
                                                               D, Dv))
    splits = ops.attention_split_plan(B, Hkv, Hq // Hkv, S, kv_len, causal, window)
    return q, k, v, splits


@pytest.mark.parametrize("case", PLAN_CASES, ids=case_id)
def test_pieces_cover_each_tile_once(case):
    """On every row tile, the pieces are ``splits`` runs of whole 32-key
    chunks, each starting where the last ended, from the chunk of the first
    key a row of the tile sees; their keys within [k_begin, k_end) cover it
    exactly once, and [k_begin, k_end) is the union of the tile's rows'
    keys."""
    B, Hkv, rep, S, kv_len, causal, window = case
    splits = ops.attention_split_plan(B, Hkv, rep, S, kv_len, causal, window)
    assert 1 <= splits <= ops.ATTENTION_MAX_SPLITS
    if rep * S >= ops.ATTENTION_TILE_ROWS:
        assert splits == 1
        return
    R = ops.attention_rows_a_block(rep * S)
    qpos = np.arange(rep * S) // rep + kv_len - S
    t = np.arange(kv_len)
    for i, (k_begin, k_end, pieces) in enumerate(
            ops.attention_pieces(S, rep, kv_len, causal, window, splits)):
        rows = qpos[i * R:(i + 1) * R, None]
        seen = np.ones((len(rows), kv_len), bool)
        if causal:
            seen &= t <= rows
        if window is not None:
            seen &= t > rows - window
        keys = np.flatnonzero(seen.any(axis=0))
        if keys.size:   # (window 0: each row's keys are none, the tile's bounds not)
            assert (k_begin, k_end) == (keys[0], keys[-1] + 1)
            assert keys.size == k_end - k_begin   # the rows' keys are one range
        assert len(pieces) == splits
        assert all(f % ops.ATTENTION_CHUNK == 0 and e % ops.ATTENTION_CHUNK == 0 and f <= e
                   for f, e in pieces)
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        if keys.size:
            assert pieces[0][0] == k_begin // ops.ATTENTION_CHUNK * ops.ATTENTION_CHUNK
            assert pieces[-1][1] - ops.ATTENTION_CHUNK < k_end <= pieces[-1][1]
        covered = np.zeros(kv_len, int)
        for f, e in pieces:
            lo, hi = max(f, k_begin), min(e, k_end)
            covered[lo:max(lo, hi)] += 1
        assert (covered[k_begin:max(k_begin, k_end)] == 1).all()
        assert covered.sum() == max(0, k_end - k_begin)


def test_plan_fills_the_card():
    """danube's decode over a rank's 4,096 keys (8 kv heads, rep 4): 8 x 32
    pieces of 128 keys, about two blocks for each of 132 SMs; a grid with a
    block for every SM already takes one piece, and so do keys of one chunk
    and a head of 64 packed rows (the tiled kernel)."""
    assert ops.attention_split_plan(1, 8, 4, 1, 4096, True, None) == 32
    pieces = ops.attention_pieces(1, 4, 4096, True, None, 32)
    assert [e - f for f, e in pieces[0][2]] == [128] * 32
    assert ops.attention_split_plan(8, 32, 1, 1, 4161, True, None) == 1       # 256 blocks
    assert ops.attention_split_plan(4, 33, 1, 1, 4096, True, None) == 1       # 132 blocks
    assert ops.attention_split_plan(4, 32, 1, 1, 4096, True, None) > 1        # 128 blocks
    assert ops.attention_split_plan(1, 8, 4, 1, 4000, True, 1) == 1           # one chunk
    assert ops.attention_split_plan(1, 2, 8, 8, 4096, True, None) == 1        # 64 rows
    for B, Hkv, rep, S, kv_len, causal, window in PLAN_CASES:
        tiles = len(ops.attention_key_chunks(S, rep, kv_len, causal, window))
        splits = ops.attention_split_plan(B, Hkv, rep, S, kv_len, causal, window)
        assert B * Hkv * tiles * splits <= 2 * ops.H100_SMS + B * Hkv * tiles
    assert ops.attention_split_plan(1, 8, 4, 1, 4096, True, None, sms=66) == 16
    assert [ops.attention_rows_a_block(r) for r in (1, 2, 3, 4, 5, 8, 9, 16, 17, 63)] == \
        [1, 2, 4, 4, 8, 8, 16, 16, 16, 16]


@pytest.mark.parametrize("case", MIRROR_CASES + SPLIT_CASES, ids=case_id)
def test_mirror_matches_the_plain_version(case, rng):
    """The pieces of the kernel's plan merged as the kernel merges them
    equal ``ref.flash_attention_ref`` within 1e-6, out and lse (+inf
    exactly where a row sees no key, whose out is 0), on the mirror's cases
    and the card tests' ``SPLIT_CASES``; no key past kv_len is read (NaN
    there)."""
    B, Hq, Hkv, S, T, kv_len, D, Dv, causal, window = case
    q, k, v, splits = _inputs(rng, case)
    out, lse = merge_partials(split_partials(q, k, v, causal, window, kv_len, splits), B, Hq, S)
    exp, exp_lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                           kv_len=kv_len, return_lse=True)
    assert torch.isfinite(out).all() and _close(out, exp, MIRROR_TOL)
    seen = torch.isfinite(exp_lse)
    assert torch.equal(torch.isfinite(lse), seen) and not out[~seen].any()
    if seen.any():
        assert _close(lse[seen], exp_lse[seen], MIRROR_TOL)


@pytest.mark.parametrize("case", MIRROR_CASES, ids=case_id)
def test_mirror_matches_jax(case, rng):
    """The same merge against the JAX package on the filled prefix (T =
    kv_len), within 1e-5: its Pallas kernel in interpret mode (one key
    block), or, where v is narrower than q and k, ``_attention_scores``."""
    B, Hq, Hkv, S, T, kv_len, D, Dv, causal, window = case
    q, k, v, splits = _inputs(rng, case)
    out, _ = merge_partials(split_partials(q, k, v, causal, window, kv_len, splits), B, Hq, S)
    qj, kj, vj = (jnp.asarray(x.numpy()) for x in (q, k[:, :, :kv_len], v[:, :, :kv_len]))
    if Dv == D:
        exp = jops.flash_attention(qj, kj, vj, causal=causal, window=window, block_q=64,
                                   block_k=kv_len, interpret=True)
    else:
        exp = _attention_scores(qj, kj, vj, causal=causal, window=window, t_total=kv_len,
                                impl="naive")
    assert _close(out, torch.from_numpy(np.asarray(exp)), JAX_TOL)


def _empty_piece(tiles):
    """(tile, row, piece) of a piece that keeps no key of a row while
    another piece of the row keeps some, or None."""
    for n, (_, _, m, _, _) in enumerate(tiles):
        empty = torch.isinf(m[0, 0]) & ~torch.isinf(m[0, 0]).all(-1, keepdim=True)
        if empty.any():
            r, i = (int(x) for x in empty.nonzero()[0])
            return n, r, i
    return None


@pytest.mark.parametrize("case", [MIRROR_CASES[i] for i in (7, 8, 9)], ids=case_id)
def test_controls_fail_the_bound(case, rng):
    """A merge without one piece that keeps keys, and one that weighs a
    piece keeping no key of a row as if it held that row's keys (another
    piece's partial, as a workspace slot left from an earlier call would
    hold), each miss ``ref.flash_attention_ref`` by more than the bound."""
    B, Hq, Hkv, S, T, kv_len, D, Dv, causal, window = case
    q, k, v, splits = _inputs(rng, case)
    exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len)
    tiles = split_partials(q, k, v, causal, window, kv_len, splits)
    assert _close(merge_partials(tiles, B, Hq, S)[0], exp, MIRROR_TOL)
    # drop the piece with the largest sum of the last tile's first row
    n = len(tiles) - 1
    r0, r1, m, l, o = tiles[n]
    i = int(torch.where(torch.isinf(m[0, 0, 0]), -1.0, l[0, 0, 0]).argmax())
    cut = (r0, r1, m.clone(), l, o)
    cut[2][..., i] = -float("inf")
    assert not _close(merge_partials(tiles[:n] + [cut] + tiles[n + 1:], B, Hq, S)[0], exp,
                      MIRROR_TOL)
    found = _empty_piece(tiles)
    assert found is not None, "the case leaves no piece of a row empty"
    n, r, i = found
    r0, r1, m, l, o = (x.clone() if torch.is_tensor(x) else x for x in tiles[n])
    j = int(torch.where(torch.isinf(m[0, 0, r]), -1.0, l[0, 0, r]).argmax())
    m[:, :, r, i], l[:, :, r, i], o[:, :, r, i] = m[:, :, r, j], l[:, :, r, j], o[:, :, r, j]
    stale = tiles[:n] + [(r0, r1, m, l, o)] + tiles[n + 1:]
    assert not _close(merge_partials(stale, B, Hq, S)[0], exp, MIRROR_TOL)
