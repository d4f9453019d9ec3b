"""Inputs of one ``frontier_expand`` level, a numpy loop that computes it, and
the comparison of two results (the ring and the cone as sets).

Shared by ``test_torch_frontier_expand.py`` (the plain version against the
loop, on the CPU) and ``test_torch_cuda.py`` (the kernel against the plain
version, on the card).  numpy only.
"""
import numpy as np

CASES = ["empty", "all_rows", "contention", "wm1", "wm2", "wm8", "degree0", "hub",
         "bad_neighbor", "bad_frontier", "pruned"]


def _words(rng, shape, p):
    """uint32 words of the given shape, each bit set with probability p."""
    bits = rng.random(tuple(shape) + (32,)) < p
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def make_case(rng, name):
    """One level's inputs (a dict of numpy arrays and ints) for case ``name``:
    a random CSR graph, frontier rows that lie across the ring's wrap, some
    rows with a verdict already computed in this sweep, some claimed for
    the next level or in the cone already."""
    n, wm, k, deg_mean, l_max = 300, 2, 60, 3.0, 8
    if name == "all_rows":
        k = n
    elif name == "empty":
        k = 0
    elif name.startswith("wm"):
        wm = int(name[2:])
    elif name == "hub":
        n, k = 3000, 40
    deg = rng.poisson(deg_mean, n)
    front = rng.choice(n, k, replace=False)
    if name == "degree0":
        deg[front[: k // 2]] = 0
    if name == "hub":
        deg[front[0]] = 1500
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    if name == "contention":   # every frontier row reaches row 7, each with its own bits
        for y in front:
            if deg[y]:
                indices[indptr[y]] = 7
    if name == "bad_neighbor":
        y = front[np.flatnonzero(deg[front])[0]]
        indices[indptr[y]] = n
    u32 = lambda shape, p: _words(rng, shape, p)  # noqa: E731
    v = u32((n, wm), 0.25)
    d_cur = np.zeros((n, wm), np.uint32)
    d_cur[front] = u32((k, wm), 0.5)
    if name == "contention":
        d_cur[front] = 0
        d_cur[front, 0] = np.uint32(1) << (np.arange(k) % 32).astype(np.uint32)
        v[7] = 0
    v |= d_cur
    d_next = u32((n, wm), 0.05)
    n_hop = n + 2
    L_tgt = rng.integers(0, n, (n + 1, l_max)).astype(np.int32)
    L_tgt[rng.random((n + 1, l_max)) < 0.4] = -1
    hop_mask = u32((n_hop, wm), 0.08)
    hop_mask[rng.random(n_hop) < 0.5] = 0
    pruned = u32((n, wm), 0.3)
    sweep, level = 5, 17
    stamps = rng.integers(0, 5, (3, n)).astype(np.int32)
    stamps[0, rng.random(n) < 0.1] = level          # claimed in this level already
    stamps[1, rng.random(n) < 0.5] = sweep          # verdict kept from an earlier level
    stamps[2, rng.random(n) < 0.3] = sweep          # in the cone already
    if name == "pruned":   # every frontier row prunes every bit it would push
        stamps[1, front] = sweep
        pruned[front] = np.uint32(0xFFFFFFFF)
    cap = 2 * n
    lo = cap - k // 2            # the level's rows lie across the ring's wrap
    frontier = rng.integers(0, n, cap).astype(np.int32)
    frontier[(lo + np.arange(k)) % cap] = front
    hi = lo + k
    if name == "bad_frontier":
        frontier[lo % cap] = n
    cone = np.zeros(n, np.int32)
    in_cone = np.flatnonzero(stamps[2] == sweep)
    cone[: in_cone.size] = rng.permutation(in_cone)
    counts = np.array([hi, in_cone.size, 0], np.int64)
    i32 = lambda a: a.view(np.int32)  # noqa: E731
    return dict(frontier=frontier, lo=int(lo), hi=int(hi), indptr=indptr, indices=indices,
                v=i32(v), pruned=i32(pruned), delta_cur=i32(d_cur), delta_next=i32(d_next),
                L_tgt=L_tgt, hop_mask=i32(hop_mask), stamps=stamps, sweep=sweep,
                level=level, cone=cone, counts=counts)


ARRAYS = ("frontier", "indptr", "indices", "v", "pruned", "delta_cur", "delta_next",
          "L_tgt", "hop_mask", "stamps", "cone", "counts")
ORDER = ("frontier", "lo", "hi", "indptr", "indices", "v", "pruned", "delta_cur",
         "delta_next", "L_tgt", "hop_mask", "stamps", "sweep", "level", "cone", "counts")


def numpy_level(case):
    """The level as plain loops over the frontier rows and their edges (the
    function ``csrc/frontier_expand.cu``'s header defines); returns a new
    case dict with the outputs."""
    c = {key: (val.copy() if isinstance(val, np.ndarray) else val) for key, val in case.items()}
    v, pruned = c["v"].view(np.uint32), c["pruned"].view(np.uint32)
    d_cur, d_next = c["delta_cur"].view(np.uint32), c["delta_next"].view(np.uint32)
    hop = c["hop_mask"].view(np.uint32)
    stamps, indptr, indices = c["stamps"], c["indptr"], c["indices"]
    n, wm = v.shape
    cap, m = c["frontier"].shape[0], indices.shape[0]
    sweep, level = c["sweep"], c["level"]
    bad, ring, joined = False, [], []
    for p in range(c["lo"], c["hi"]):
        y = int(c["frontier"][p % cap])
        if not 0 <= y < n:
            bad = True
            continue
        if stamps[1, y] != sweep:
            acc = np.zeros(wm, np.uint32)
            for h in c["L_tgt"][y]:
                if h == -1:
                    continue
                if not 0 <= h < hop.shape[0]:
                    bad = True
                    continue
                acc |= hop[h]
            pruned[y] = acc
            stamps[1, y] = sweep
        bits = d_cur[y] & ~pruned[y]
        d_cur[y] = 0
        e0, e1 = int(indptr[y]), int(indptr[y + 1])
        if e0 < 0 or e1 > m or e1 < e0:
            bad = True
            continue
        for s in range(e0, e1):
            x = int(indices[s])
            if not 0 <= x < n:
                bad = True
                continue
            gained = bits & ~v[x]
            v[x] |= bits
            d_next[x] |= gained
            if gained.any() and stamps[0, x] != level:
                stamps[0, x] = level
                ring.append(x)
                if stamps[2, x] != sweep:
                    stamps[2, x] = sweep
                    joined.append(x)
    pos = (int(c["counts"][0]) + np.arange(len(ring))) % cap
    c["frontier"][pos] = ring
    c0 = int(c["counts"][1])
    c["cone"][c0: c0 + len(joined)] = joined
    c["counts"] += np.array([len(ring), len(joined), 0])
    if bad:
        c["counts"][2] = 1
    return c


def assert_same_level(before, a, b, tag=""):
    """Two results of one level (dicts of numpy arrays) agree: every word,
    stamp and count exactly, the ring's and the cone's new entries as sets,
    and every other ring and cone entry unchanged."""
    for key in ("v", "pruned", "delta_cur", "delta_next", "stamps", "counts"):
        assert np.array_equal(a[key], b[key]), (tag, key)
    cap = before["frontier"].shape[0]
    new = (int(before["counts"][0]) + np.arange(int(a["counts"][0] - before["counts"][0]))) % cap
    old = np.setdiff1d(np.arange(cap), new)
    assert sorted(a["frontier"][new]) == sorted(b["frontier"][new]), (tag, "ring")
    assert np.array_equal(a["frontier"][old], before["frontier"][old]), (tag, "ring kept")
    assert np.array_equal(b["frontier"][old], before["frontier"][old]), (tag, "ring kept")
    c0, c1 = int(before["counts"][1]), int(a["counts"][1])
    assert sorted(a["cone"][c0:c1]) == sorted(b["cone"][c0:c1]), (tag, "cone")
    for r in (a, b):
        assert np.array_equal(r["cone"][:c0], before["cone"][:c0]), (tag, "cone kept")
        assert np.array_equal(r["cone"][c1:], before["cone"][c1:]), (tag, "cone kept")
