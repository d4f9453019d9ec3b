"""Inputs of K1's tier form (``ops.tier_intersect``) and K2's slab form
(``ops.frontier_or``) at the edges of their card designs.

``kernels/csrc/label_intersect.cu`` answers a query with 4 lanes, 16-byte
loads only where both widths are a multiple of 4 on 16-byte aligned
matrices (4 bytes a lane otherwise), rows past a group's 16 entries in a
loop, the ids one 8-byte load (two 4-byte loads where the queries start 4
bytes off 8-byte alignment), and false for an id outside [0, n) without
reading memory.
``kernels/csrc/frontier_or.cu`` gives a row wm / 4 threads of four 16-byte
words where wm is a multiple of 4 on 16-byte aligned f and out (wm threads
of one word otherwise), reads a row's ids 16 slots at a time (as 16-byte
vectors where d is a multiple of 4 on an aligned slab) and gathers 4
frontier rows at once.

Shared by ``test_torch_cuda.py`` and ``chip_smoke.py`` (each kernel against
its plain version, on the card); the CPU tests hold the plain versions
against the JAX package on the same shapes.  numpy only.
"""
import numpy as np

INVALID = -1

# K1's tier form: resident matrices of TIER_N rows
TIER_N = 3000
TIER_SHAPES = [(13, 7), (17, 5), (16, 8)]   # (Lo, Li): widths not a multiple of 4, the main path's
TIER_LAYOUTS = ["prefix", "holes"]
TIER_BATCHES = [1, 31, 33, 4099]
TIER_WIDTHS = [5, 8, 16, 128]               # 128: above both matrices


def tier_rows(rng, n, L, layout):
    """int32[n, L] label rows: ``prefix``, a sorted valid prefix and INVALID
    after it (the oracle's layout); ``holes``, INVALID anywhere and, in half
    the rows, before every valid value."""
    m = rng.integers(0, 400, size=(n, L)).astype(np.int32)
    if layout == "prefix":
        m.sort(axis=1)
        m[np.arange(L)[None, :] >= rng.integers(0, L + 1, size=n)[:, None]] = INVALID
    else:
        m[rng.random((n, L)) < 0.3] = INVALID
        lead = rng.integers(0, L, size=n) * (rng.random(n) < 0.5)
        m[np.arange(L)[None, :] < lead[:, None]] = INVALID
    return m


def unaligned(x):
    """A copy of the contiguous tensor ``x`` that starts 4 bytes into its
    buffer: contiguous, not 16-byte aligned."""
    flat = x.new_empty(x.numel() + 1)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def tier_queries(rng, n, B):
    """int32[B, 2] ids in [0, n), the last query (n - 1, n - 1)."""
    q = rng.integers(0, n, size=(B, 2)).astype(np.int32)
    q[-1] = (n - 1, n - 1)
    return q


def bad_id_queries(rng, n, B):
    """(queries, mask): ``tier_queries`` with ids -1, n and 2**31 - 1 on
    either side in the rows ``mask`` marks; the kernel answers them false."""
    q = tier_queries(rng, n, B)
    big = 2**31 - 1
    bad = np.array([[-1, 0], [0, -1], [n, 0], [0, n], [big, 0], [0, big], [-1, big]],
                   np.int32)
    rows = rng.choice(B, size=min(B, len(bad)), replace=False)
    q[rows] = bad[: rows.size]
    mask = np.zeros(B, bool)
    mask[rows] = True
    return q, mask


# K2's slab form: (r, n_src) rows and sources, every (wm, d) pair
SLAB_R, SLAB_N_SRC = 257, 300
SLAB_WM = [1, 3, 8, 9, 32]
SLAB_D = [1, 7, 16, 20, 32, 33]   # 20, 32: 16-byte id vectors over two chunks


def slab_case(rng, r, d, n_src, wm):
    """(nbr int32[r, d] with 35% INVALID, f uint32[n_src, wm] random words)."""
    nbr = rng.integers(0, n_src, size=(r, d)).astype(np.int32)
    nbr[rng.random((r, d)) < 0.35] = INVALID
    f = rng.integers(0, 2**32, size=(n_src, wm), dtype=np.uint32)
    return nbr, f


def fused_case(rng, r, wm, n_out=None):
    """(perm int64[r] of distinct rows of out, out0 uint32[n_out, wm]) for the
    fused form; n_out defaults to r + 7."""
    n_out = r + 7 if n_out is None else n_out
    perm = rng.permutation(n_out)[:r].astype(np.int64)
    out0 = rng.integers(0, 2**32, size=(n_out, wm), dtype=np.uint32)
    out0[rng.random(n_out) < 0.5] = 0   # rows that gain bits beside rows that may not
    return perm, out0


def bad_slab(rng, r, d, n_src, wm):
    """``slab_case`` and ``fused_case`` with ids n_src and -2 and a perm
    entry n_out (the fused form skips each and sets flags[1])."""
    nbr, f = slab_case(rng, r, d, n_src, wm)
    perm, out0 = fused_case(rng, r, wm)
    nbr[0, 0] = n_src
    nbr[r // 2, d - 1] = -2
    perm[r - 1] = out0.shape[0]
    return nbr, f, perm, out0
