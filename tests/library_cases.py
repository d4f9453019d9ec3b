"""Inputs of the kernel library's K3 ``bitset_mm`` and K5 ``ell_spmm`` at
their edges: the JAX package's kernel sweeps (``tests/test_kernels.py``),
then the edges of the card's designs (``kernels/csrc/bitset_mm.cu``: 2,048
words of ``a`` a range, 2,048 set columns a list, 2,048 output words a
column chunk; ``kernels/csrc/ell_spmm.cu``: 32 slots a read, 16-byte
loads only on 16-byte aligned rows), then the shapes of
``benchmarks/kernel_bench.py``.

Shared by ``test_torch_cuda.py`` and ``chip_smoke.py`` (each kernel against
its plain version, on the card).  numpy only.
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
