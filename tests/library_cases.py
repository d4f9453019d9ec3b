"""Inputs of the kernel library's K3 ``bitset_mm``, K4 ``flash_attention``
in float32, K5 ``ell_spmm`` and K6 ``embedding_bag`` at their edges: the JAX
package's kernel sweeps (``tests/test_kernels.py``), then the edges of the
card's designs (``kernels/csrc/bitset_mm.cu``: 2,048 words of ``a`` a range,
2,048 set columns a list, 2,048 output words a column chunk;
``kernels/csrc/flash_attention.cu``: 64 packed query rows and 64 keys a
tile, fewer rows a (batch, kv head) on the short-row kernel, masks only on
edge tiles, 16-byte output chunks to D = 64 and past it;
``kernels/csrc/ell_spmm.cu``: 32 slots a read, 16-byte loads only on
16-byte aligned rows; ``kernels/csrc/embedding_bag.cu``: 8, 16 or 32 lanes a
bag, 8 slots a group, 8-byte loads only for even D on 8-byte aligned
tables, rows wider than 32 loads in column chunks), then the shapes of
``benchmarks/kernel_bench.py``.

Shared by ``test_torch_cuda.py`` and ``chip_smoke.py`` (each kernel against
its plain version, on the card) and ``test_torch_kernel_library.py`` (the
plain versions against the JAX package on the CPU).  numpy only.
"""
import numpy as np

# (n, k, m, edge): a uint32[n, ceil(k/32)] times x uint32[k, ceil(m/32)]
BITSET_CASES = [(16, 32, 32, None), (70, 90, 100, None), (128, 256, 64, None),
                (1, 90, 8, None), (70, 90, 100, "bit31"), (70, 90, 100, "last"),
                (70, 90, 100, "zero"), (1024, 1024, 1024, None),
                # wm = 5, 6, 7: 1, 2 and 3 (mod 4) words, rows of x off 16-byte lines
                (70, 90, 160, None), (70, 90, 192, None), (70, 90, 224, None),
                # dense rows with more set columns than one list holds, every other
                # row all zero; k past one range of a
                (8, 5000, 100, "dense_zero"), (4, 70_000, 96, "dense_zero"),
                # an output row wider than one column chunk; n = 1 at the closure's wm
                (6, 100, 70_000, None), (1, 5000, 1213 * 32, "bit31")]

# (n, d, n_src, F, edge): nbr int32[n, d], wgt float32[n, d], x float32[n_src, F]
SPMM_CASES = [(32, 4, 50, 8, None), (96, 7, 200, 32, None), (64, 1, 64, 128, None),
              (96, 7, 200, 100, "all_padding"), (1, 9, 40, 100, None),
              (96, 7, 200, 33, "last_id"), (4096, 16, 4096, 64, "no_padding"),
              # d > 32 and d = 1; F = 1, 33, 100, 128 and past one 32-lane load (128);
              # rows of all padding beside full rows; x off 16-byte lines
              (96, 70, 200, 100, "alternate"), (64, 1, 64, 1, None),
              (64, 40, 300, 33, "alternate"), (96, 33, 200, 128, "alternate"),
              (50, 40, 100, 260, None), (96, 7, 200, 100, "unaligned"),
              (64, 40, 300, 128, "unaligned")]


# (B, Hq, Hkv, S, T, D, causal, window): K4 in float32 at the edges of its
# tiled kernel (64 packed rows rep * S a block, 64 keys a tile)
ATTENTION_F32_CASES = [(1, 2, 2, 63, 63, 64, True, None),      # 63 rows: short-row kernel
                       (1, 2, 2, 64, 64, 64, True, None),      # 64 rows: one tile
                       (1, 2, 2, 65, 65, 64, True, None),      # 65: a tile and one row
                       (1, 8, 2, 16, 100, 32, True, None),     # rep 4, 64 rows, S < T
                       (2, 8, 1, 9, 200, 16, True, None),      # rep 8, 72 rows
                       (1, 4, 2, 100, 150, 8, True, None),     # D = 8, S and T off tiles
                       (1, 4, 4, 130, 190, 72, False, None),   # D = 72, rep 1, no mask
                       (1, 4, 1, 70, 300, 128, True, None),    # D = 128, rep 4
                       (1, 4, 2, 200, 200, 64, True, 10),      # window under one tile
                       (1, 4, 2, 200, 260, 64, False, 10),     # the same without causal
                       (1, 2, 1, 150, 100, 64, True, None),    # S > T: rows see no key
                       (1, 4, 2, 100, 100, 32, True, 0),       # window 0: no row sees one
                       (1, 4, 2, 129, 257, 64, True, 65),      # window one past a tile
                       (2, 8, 2, 256, 256, 64, True, None),    # many row tiles, causal
                       (3, 32, 8, 1, 300, 64, True, None),     # decode, rep 4
                       (1, 8, 1, 1, 129, 128, True, 64)]       # decode, rep 8, window

# (V, D, B, bag, edge): table float32[V, D], idx int32[B, bag]; the first
# cases were chip_smoke.py's
BAG_CASES = [(100, 8, 32, 4, None), (500, 16, 64, 9, None), (64, 32, 16, 1, None),
             (1000, 10, 300, 8, "all_padding"), (1000, 10, 1, 8, None),
             (1000, 10, 300, 8, "last_id"), (100_000, 16, 8192, 8, "no_padding"),
             # D = 1 (8 lanes a bag, 1 reads), 10 (5 float2 loads), 11 (odd: 4-byte
             # loads), 64 (32 lanes a bag) and past one column chunk (130, 129);
             # bag 1, 8, 9 (a second slot group) and 40; a table off 8-byte lines
             (50, 1, 37, 1, None), (300, 1, 70, 9, "last_id"), (1000, 10, 333, 9, None),
             (5000, 10, 1000, 40, "all_padding"), (1000, 11, 100, 8, "all_padding"),
             (700, 11, 50, 40, "last_id"), (200, 11, 300, 1, None),
             (2000, 64, 100, 40, None), (500, 64, 33, 1, "all_padding"),
             (128, 130, 20, 9, None), (100, 129, 10, 8, "last_id"),
             (1000, 10, 300, 8, "unaligned")]


def case_id(case) -> str:
    return "-".join(str(v) for v in case if v is not None)


def make_bitset_case(rng, n, k, m, edge):
    """(a, x) as int32 bit patterns; ``edge`` None (random words), "bit31"
    (only bit 31 of each word of a), "last" (only column k - 1), "zero" (no
    bit) or "dense_zero" (random, every other row of a all zero)."""
    wk, wm = (k + 31) // 32, (m + 31) // 32
    a = rng.integers(0, 2**32, size=(n, wk), dtype=np.uint32)
    x = rng.integers(0, 2**32, size=(k, wm), dtype=np.uint32)
    if edge == "bit31":
        a &= np.uint32(1 << 31)
    elif edge == "last":
        a[:] = 0
        a[:, -1] = np.uint32(1) << np.uint32((k - 1) % 32)
    elif edge == "zero":
        a[:] = 0
    elif edge == "dense_zero":
        a[::2] = 0
    return a.view(np.int32), x.view(np.int32)


def make_spmm_case(rng, n, d, ns, F, edge):
    """(nbr, wgt, x); ``edge`` None (30% padding), "no_padding",
    "all_padding" (the first half of the rows all padding), "last_id" (slot 0
    is n_src - 1), "alternate" (even rows all padding, odd rows full) or
    "unaligned" (30% padding; the caller moves x off 16-byte lines)."""
    nbr = rng.integers(0, ns, size=(n, d)).astype(np.int32)
    if edge != "no_padding":
        nbr[rng.random((n, d)) < 0.3] = -1
    if edge == "all_padding":
        nbr[: n // 2] = -1
    elif edge == "last_id":
        nbr[:, 0] = ns - 1
    elif edge == "alternate":
        nbr[::2] = -1
        nbr[1::2] = rng.integers(0, ns, size=nbr[1::2].shape)
    wgt = rng.standard_normal((n, d)).astype(np.float32)
    x = rng.standard_normal((ns, F)).astype(np.float32)
    return nbr, wgt, x


def padding_rows(n, edge) -> slice:
    """The rows of a case whose every slot is padding (out must be 0 there)."""
    return {"all_padding": slice(0, n // 2), "alternate": slice(0, n, 2)}.get(edge,
                                                                                slice(0, 0))


def make_bag_case(rng, V, D, B, bag, edge):
    """(table, idx); ``edge`` None (a quarter of the slots padding, with ids
    from the whole negative range), "no_padding", "all_padding" (the first
    half of the bags all padding), "last_id" (slot 0 is V - 1) or
    "unaligned" (a quarter padding; the caller moves the table off 8-byte
    lines)."""
    idx = rng.integers(0, V, size=(B, bag)).astype(np.int32)
    if edge != "no_padding":
        pad = rng.random((B, bag)) < 0.25
        idx[pad] = rng.integers(-2**31, 0, size=int(pad.sum()))   # any negative pads
    if edge == "all_padding":
        idx[: B // 2] = -1
    elif edge == "last_id":
        idx[:, 0] = V - 1
    table = rng.standard_normal((V, D)).astype(np.float32)
    return table, idx


# (B, Hq, Hkv, S, T, kv_len, D, window): K4 over a preallocated cache of T keys
# of which kv_len exist (the decode path's call): kv_len 1, a 64-key tile's
# edge and one past it, T; danube's window cutting, deepseek-7b's heads (rep
# 1, D = 128), and S > 1 on the float32 tiled kernel.  Callers put NaN past
# kv_len, so a kernel that read a key there fails
KV_LEN_CASES = [(2, 32, 8, 1, 320, 1, 64, None), (2, 32, 8, 1, 320, 63, 64, None),
                (2, 32, 8, 1, 320, 64, 64, None), (2, 32, 8, 1, 320, 65, 64, None),
                (2, 32, 8, 1, 320, 320, 64, None),
                (2, 32, 8, 1, 4176, 4161, 80, 4096),
                (2, 32, 32, 1, 300, 129, 128, None),
                (1, 4, 2, 100, 300, 229, 64, None),
                (1, 4, 2, 100, 300, 129, 64, 65)]


def make_kv_len_case(rng, B, Hq, Hkv, S, T, kv_len, D, Dv=None):
    """(q, k, v) float32, v ``Dv`` wide (default D), k and v NaN at the keys
    t >= kv_len."""
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, Dv or D)).astype(np.float32)
    k[:, :, kv_len:] = np.nan
    v[:, :, kv_len:] = np.nan
    return q, k, v


# (B, Hq, Hkv, S, T, kv_len, D, Dv, causal, window): K4 with a value width of
# its own, MLA's prefill (D = 192 = 128 + 64 with rope, Dv = 128, 16 heads) and
# its edges: 64-row tiles, ragged S and T, a window, a float32 head of fewer
# than 64 rows (the short-row kernel), a decode step and S > 1 over a cache
# (kv_len; callers put NaN past it), D padded to 192 and Dv to 128, and Dv < D
# at D <= 128 (V's columns past Dv zero-filled)
ATTENTION_DV_CASES = [(1, 16, 16, 256, 256, None, 192, 128, True, None),
                      (1, 4, 4, 130, 130, None, 192, 128, True, None),
                      (1, 4, 2, 70, 127, None, 192, 128, True, 65),
                      (1, 2, 2, 63, 63, None, 192, 128, True, None),
                      (1, 4, 4, 64, 200, None, 192, 128, False, None),
                      (2, 16, 16, 1, 320, 129, 192, 128, True, None),
                      (1, 4, 4, 100, 300, 229, 192, 128, True, None),
                      (1, 2, 1, 100, 100, None, 136, 64, False, None),
                      (1, 4, 2, 100, 100, None, 128, 64, True, None),
                      (1, 4, 2, 64, 90, None, 24, 8, True, 33)]

