"""Inputs of one ``serve_batch`` call (K1's batch form) and a numpy loop that
computes its codes.

Shared by ``test_torch_serve_batch.py`` (the plain version against the loop,
on the CPU), ``test_torch_cuda.py`` and ``chip_smoke.py`` (the kernel
against the plain version, on the card).  numpy only.

A case is a dict: ``L_out`` int32[n, Lo] and ``L_in`` int32[n, Li] (sorted
valid prefixes, INVALID after each row's length, as the oracle lays them
out), ``out_len`` / ``in_len`` int32[n], ``level`` int32[n] or None,
``widths`` (ascending ints) and ``queries`` int32[B, 2].  A case whose name
starts with ``bad_`` holds an id outside [-n, n), which must raise
``IndexError``.  A case whose name starts with ``mask_`` also holds
``trunc_out`` / ``trunc_in``, the packed truncation masks of a memory budget
(uint8[ceil(n / 8)], ``np.packbits`` order), which ``ops.ServeBatch`` and
``ref.serve_batch_ref`` take as keywords (``MASKS``); other cases hold None.
"""
import numpy as np

# ops.ServeBatch's tensor arguments, in order (``widths`` follows them)
BINDING = ("L_out", "L_in", "out_len", "in_len", "level")
# its keyword arguments under a budget
MASKS = ("trunc_out", "trunc_in")
# bit 7 of a code: a false verdict the truncated labels cannot prove
UNCERTAIN = 0x80

CASES = ["empty", "one", "b4097", "all_prefiltered", "none_prefiltered", "no_level",
         "one_tier", "three_tiers", "corner_ids", "full_rows", "invalid_inside",
         "negative_ids", "wide_rows", "odd_widths", "clamped", "bad_id_high", "bad_id_low",
         # under a budget: a random cut, rows cut to length 0, u == v and
         # level[u] >= level[v] with both rows cut, one side cut only, no
         # level, and n = 301, whose last mask byte is partial
         "mask_random", "mask_empty_rows", "mask_same_vertex", "mask_level_ge",
         "mask_one_side", "mask_no_level", "mask_partial_byte"]


def _rows(rng, n, L, lens, values):
    """int32[n, L]: row i holds lens[i] distinct sorted values, then INVALID."""
    mat = np.full((n, L), -1, np.int32)
    for i in range(n):
        mat[i, : lens[i]] = np.sort(rng.choice(values, int(lens[i]), replace=False))
    return mat


def make_case(rng, name):
    n, Lo, Li, values = 300, 16, 8, 60
    widths = [8, 16]
    B = 700
    if name == "mask_partial_byte":
        n = 301
    if name == "wide_rows":
        Lo, Li, widths, values = 40, 24, [8, 24, 40], 200
    elif name == "odd_widths":
        Lo, Li = 13, 7
    elif name == "three_tiers":
        Lo, Li, widths = 24, 24, [8, 16, 24]
    elif name == "one_tier":
        widths = [16]
    elif name == "clamped":
        widths = [8]   # rows up to 16 long: the last tier truncates them
    low = 1 if name in ("none_prefiltered", "full_rows") else 0
    out_len = rng.integers(low, Lo + 1, n).astype(np.int32)
    in_len = rng.integers(low, Li + 1, n).astype(np.int32)
    if name == "full_rows":
        out_len[:], in_len[:] = Lo, Li
    L_out = _rows(rng, n, Lo, out_len, values)
    L_in = _rows(rng, n, Li, in_len, values)
    if name == "invalid_inside":   # an INVALID inside the valid part of some rows
        for L, lens in ((L_out, out_len), (L_in, in_len)):
            rows = np.flatnonzero(lens >= 2)[::3]
            L[rows, rng.integers(0, lens[rows])] = -1
    level = None if name in ("no_level", "none_prefiltered", "mask_no_level") else \
        rng.integers(0, 12, n).astype(np.int32)
    if name == "empty":
        B = 0
    elif name == "one":
        B = 1
    elif name == "b4097":
        B = 4097
    q = rng.integers(0, n, (B, 2)).astype(np.int32)
    if name == "all_prefiltered":
        out_len[::2] = 0
        L_out[::2] = -1
        q[: B // 2, 1] = q[: B // 2, 0]                     # u == v
        q[B // 2:, 0] = rng.choice(np.arange(0, n, 2), B - B // 2)   # out_len[u] == 0
    elif name == "none_prefiltered":
        q[:, 1] = np.where(q[:, 1] == q[:, 0], (q[:, 0] + 1) % n, q[:, 1])
    elif name == "corner_ids":
        q[: B // 2] = rng.choice([0, n - 1], (B // 2, 2))
    elif name == "negative_ids":
        q[::2] -= n                                         # in [-n, 0)
        q[1, 0] = -1
    elif name == "bad_id_high":
        q[B // 3, 1] = n
    elif name == "bad_id_low":
        q[B // 2, 0] = -n - 1
    masks = {k: None for k in MASKS}
    if name.startswith("mask_"):
        cut_out = rng.random(n) < 0.6
        cut_in = rng.random(n) < 0.6
        if name == "mask_empty_rows":        # rows cut to length 0, and cut
            rows = rng.choice(n, n // 4, replace=False)
            cut_out[rows] = cut_in[rows] = True
            out_len[rows[::2]] = 0
            L_out[rows[::2]] = -1
            in_len[rows[1::2]] = 0
            L_in[rows[1::2]] = -1
        elif name == "mask_same_vertex":     # u == v, both rows cut
            cut_out[:] = cut_in[:] = True
            q[::2, 1] = q[::2, 0]
        elif name == "mask_level_ge":        # level[u] >= level[v], both rows cut
            cut_out[:] = cut_in[:] = True
            level[q[::2, 0]] = 20   # above every other level: level[u] >= level[v]
        elif name == "mask_one_side":        # never both sides of a query
            cut_in[:] = False
        elif name == "mask_partial_byte":    # the last rows, in the partial byte
            q[: B // 2] = rng.integers(n - 5, n, (B // 2, 2))
        masks = {"trunc_out": np.packbits(cut_out), "trunc_in": np.packbits(cut_in)}
    return {"L_out": L_out, "L_in": L_in, "out_len": out_len, "in_len": in_len,
            "level": level, "widths": widths, "queries": q, **masks}


def numpy_codes(case):
    """uint8[B] codes by a loop over the queries: ``2 * fate + verdict``, fate
    0 for a prefiltered query and 1 + t for one intersected in tier t, and
    under a budget ``UNCERTAIN`` on a false verdict with both rows cut,
    u != v and (level given) level[u] < level[v]."""
    L_out, L_in, out_len, in_len, level, widths, queries = (
        case[k] for k in (*BINDING, "widths", "queries"))
    n = L_out.shape[0]
    cut = None
    if case.get("trunc_out") is not None:
        cut = [np.unpackbits(case[k], count=n).astype(bool) for k in MASKS]
    codes = np.zeros(queries.shape[0], np.uint8)
    for i, (u, v) in enumerate(queries.astype(np.int64)):
        if not (-n <= u < n and -n <= v < n):
            raise IndexError(f"query ids outside [-{n}, {n})")
        u, v = u % n, v % n
        if u == v:
            codes[i] = 1
        elif out_len[u] == 0 or in_len[v] == 0 or (level is not None and level[u] >= level[v]):
            codes[i] = 0
        else:
            t = min(int(np.searchsorted(widths, max(out_len[u], in_len[v]), side="left")),
                    len(widths) - 1)
            w = widths[t]
            a, b = set(L_out[u, :w].tolist()) - {-1}, set(L_in[v, :w].tolist()) - {-1}
            codes[i] = 2 * (t + 1) + bool(a & b)
        if cut is not None and not codes[i] & 1 and cut[0][u] and cut[1][v] and u != v \
                and (level is None or level[u] < level[v]):
            codes[i] |= UNCERTAIN
    return codes
