"""Wave scheduler: batch Algorithm 2 iterations that provably commute.

Distribution-Labeling's outer loop is sequential in the §5.2 rank order, but
consecutive iterations commute whenever no wave member can reach another:

  * v_i's reverse pass appends v_i to L_out(u) for ancestors u; that append
    can only flip v_j's prune test L_out(u) ∩ L_in(v_j) if v_i ∈ L_in(v_j),
    i.e. v_i -> v_j.
  * symmetrically for the forward pass and v_j -> v_i.

So a *wave* = a maximal run of consecutive rank-order vertices that are
pairwise mutually unreachable; the whole wave runs as one batched sweep with
bit-per-member state and the result is exactly the sequential labeling (the
engine's differential tests assert byte-identity).

Two schedulers produce such partitions:

``scheduler="onepass"`` (default) — the one-pass rank-windowed scheduler.
The conflict relation is computed ONCE per build: candidates are seeded in
*pages* of consecutive ranks, each page's closure bits propagated through
its cones once into a persistent two-parity scratch, and the page's
conflict PAIRS extracted once into (rank-sorted, suffix-min) arrays.  Waves
are then carved greedily with one binary search per wave, so they cross
page boundaries freely and every carve window that overlaps a page REUSES
its propagated closure and extracted pairs — the blocked scheduler instead
re-materializes a dense per-block conflict matrix (its hottest line on
overlap-heavy tree graphs, the ~20-40% scheduler share ROADMAP calls out)
and truncates every wave at block boundaries.

``scheduler="blocked"`` — the original per-block closure scheduler, kept as
the equivalence reference (with ``block >= n`` both schedulers produce the
identical partition; tests assert it).

Certification inside either scheduler is two-tier, both sides conservative:

1. GRAIL-style DFS intervals (Yildirim et al., PAPERS.md): a DFS of a DAG
   assigns post-order numbers and ``low[v] = min(post over Reach(v))``; then
   ``u -> v  ==>  post[v] in [low[u], post[u]]`` for every traversal.  One
   vectorized all-pairs check refutes most pairs for free.  (Topo levels
   would add nothing here: they can only *confirm* reachability, never
   refute an interval false positive.)
2. An exact closure: budget-bounded multi-source reach propagation of
   per-candidate bit masks.  If it completes within budget it yields the
   *true* pairwise reachability among the candidates (bit a arriving at
   candidate b means a -> b).  Sparse graphs — exactly the ones whose BFS
   regions are tiny and therefore batch well — complete almost every
   closure; hub-dominated ranges blow the budget and fall back to the
   interval verdict (after a circuit breaker pays for the intervals once).

A copy of ``repro.build.waves`` (numpy only): the same graph and order give
the same wave lengths (``tests/test_torch_waves.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.build import bitset
from repro_torch.graph.csr import CSRGraph


def _reverse_within_rows(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """indices with every CSR row's neighbor list reversed (tie-break flip)."""
    m = indices.shape[0]
    counts = np.diff(indptr).astype(np.int64)
    starts = indptr[:-1].astype(np.int64)
    cum = np.cumsum(counts)
    pos_in_row = np.arange(m, dtype=np.int64) - np.repeat(cum - counts, counts)
    dest = np.repeat(starts + counts - 1, counts) - pos_in_row
    out = np.empty_like(indices)
    out[dest] = indices
    return out


def dfs_post_low(
    indptr: np.ndarray,
    indices: np.ndarray,
    roots: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One DFS sweep over a DAG: (post, low) int64[n].

    post[v] = post-order number; low[v] = min post over Reach(v) (computable
    at finish time because every out-neighbor of a DAG vertex is already
    finished).  [low[v], post[v]] contains post[d] for every descendant d and
    post[v] itself.
    """
    n = indptr.shape[0] - 1
    iptr = indptr.tolist()
    idx = indices.tolist()
    post = [0] * n
    low = [0] * n
    state = bytearray(n)  # 0 new, 1 open, 2 done
    t = 0
    root_iter = range(n) if roots is None else roots.tolist()
    for r in root_iter:
        if state[r]:
            continue
        state[r] = 1
        stack = [r]
        ptr = [iptr[r]]
        while stack:
            v = stack[-1]
            p = ptr[-1]
            if p < iptr[v + 1]:
                ptr[-1] = p + 1
                w = idx[p]
                if not state[w]:
                    state[w] = 1
                    stack.append(w)
                    ptr.append(iptr[w])
            else:
                stack.pop()
                ptr.pop()
                lo = t
                for q in range(iptr[v], iptr[v + 1]):
                    lw = low[idx[q]]
                    if lw < lo:
                        lo = lw
                post[v] = t
                low[v] = lo
                state[v] = 2
                t += 1
    return np.asarray(post, dtype=np.int64), np.asarray(low, dtype=np.int64)


def dfs_intervals(g: CSRGraph, n_traversals: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """(post, low) stacked over traversals: int64[T, n] each.

    Traversal 0 uses natural root/neighbor order; traversal 1 flips both;
    further traversals use seeded random root/neighbor permutations.  More
    traversals refute more interval false positives (a pair is only "maybe"
    if EVERY traversal allows it) — the exact rescue in ``wave_schedule``
    makes 2 enough in practice.
    """
    posts, lows = [], []
    rng = np.random.default_rng(0x5EED)
    for t in range(n_traversals):
        if t == 0:
            p, l = dfs_post_low(g.indptr, g.indices)
        elif t == 1:
            p, l = dfs_post_low(
                g.indptr,
                _reverse_within_rows(g.indptr, g.indices),
                roots=np.arange(g.n - 1, -1, -1),
            )
        else:
            key = rng.random(g.m)
            row = np.repeat(np.arange(g.n), np.diff(g.indptr))
            p, l = dfs_post_low(
                g.indptr,
                g.indices[np.lexsort((key, row))],
                roots=rng.permutation(g.n),
            )
        posts.append(p)
        lows.append(l)
    return np.stack(posts), np.stack(lows)


def _interval_conflicts(P: np.ndarray, L: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """bool[c, c] — conflict[a, b] = some traversal allows a -> b or b -> a."""
    p = P[:, cand]  # [T, c]
    l = L[:, cand]
    maybe = ((p[:, None, :] >= l[:, :, None]) & (p[:, None, :] <= p[:, :, None])).all(axis=0)
    return maybe | maybe.T


def _exact_conflicts(
    indptr: np.ndarray,
    indices: np.ndarray,
    cand: np.ndarray,
    scratch: np.ndarray,
    budget: int,
) -> Optional[np.ndarray]:
    """Exact pairwise reachability among candidates via a multi-source
    closure BFS with packed candidate-bit masks; None if the edge budget is
    exhausted (verdict would be unsound when truncated)."""
    c = cand.shape[0]
    mbits = bitset.member_bits(c, scratch.shape[1])
    scratch[cand] = mbits
    touched = [cand]
    frontier, fbits = cand, mbits
    edges = 0
    completed = True
    while frontier.size:
        # budget check BEFORE the gather: a single hub level can carry the
        # whole graph, and a doomed block must abort cheaply
        edges += int((indptr[frontier + 1] - indptr[frontier]).sum())
        if edges > budget:
            completed = False
            break
        nbrs, seg = bitset.csr_gather(indptr, indices, frontier)
        if nbrs.shape[0] == 0:
            break
        uniq, obits = bitset.group_or(nbrs, fbits[seg])  # indices already int64
        new = obits & ~scratch[uniq]
        keep = new.any(axis=1)
        frontier = uniq[keep]
        fbits = new[keep]
        scratch[frontier] |= fbits
        touched.append(frontier)
    if completed:
        arrived = scratch[cand] ^ mbits  # bits of OTHER candidates reaching each
        # conflicts are sparse: unpack only rows that received any bit
        nz = np.flatnonzero(arrived.any(axis=1))
        m = np.zeros((c, c), dtype=bool)  # m[b, a] = a -> b
        if nz.size:
            m[nz] = bitset.masks_to_matrix(arrived[nz], c)
        conflict = m | m.T
    scratch[np.concatenate(touched)] = 0
    return conflict if completed else None


# circuit breaker: after this many blown closures, pay for the DFS
# intervals once and stop bisecting (shared by both schedulers)
_BLOW_LIMIT = 64

_TRIU_CACHE: list = [np.zeros((0, 0), dtype=bool)]


def _triu_mask(c: int) -> np.ndarray:
    """Cached strict upper-triangle mask view (np.triu allocates per call)."""
    if _TRIU_CACHE[0].shape[0] < c:
        size = max(c, 256)
        _TRIU_CACHE[0] = np.triu(np.ones((size, size), dtype=bool), k=1)
    return _TRIU_CACHE[0][:c, :c]


def _block_waves(conflict: np.ndarray, c: int, max_wave: int, lengths: list) -> None:
    """Greedily split one block's conflict matrix into consecutive waves."""
    pos = 0
    while pos < c:
        limit = min(max_wave, c - pos)
        sub = conflict[pos : pos + limit, pos : pos + limit]
        bad = (sub & _triu_mask(limit)).any(axis=0)  # b conflicts with some a < b
        nz = np.flatnonzero(bad)
        wlen = max(int(nz[0]) if nz.size else limit, 1)
        lengths.append(wlen)
        pos += wlen


def wave_schedule_blocked(
    g: CSRGraph,
    order: np.ndarray,
    max_wave: int = 256,
    block: int = 256,
    n_traversals: int = 2,
    intervals: Tuple[np.ndarray, np.ndarray] | None = None,
    exact_budget: Optional[int] = None,
    abort_below_avg: Optional[float] = None,
) -> Optional[np.ndarray]:
    """The per-block closure scheduler (the original implementation).

    Block-and-split: one exact closure covers a whole ``block`` of
    consecutive vertices, and every wave inside the block is carved out of
    that single conflict matrix.  Larger blocks amortize closure calls but
    pay more mask words per edge.  When a block blows the closure budget (a
    hub cone is in range), bisect it so the hub lands in a small block
    alone; if closures keep blowing (closure-hostile graph), a circuit
    breaker pays once for the DFS intervals and uses them for all remaining
    fallbacks.

    Kept as the equivalence reference for the one-pass windowed scheduler
    (``wave_schedule``): with ``block >= len(order)`` both produce the
    identical partition.  See ``wave_schedule`` for the parameter contract.
    """
    order = np.asarray(order, dtype=np.int64)
    n_total = order.shape[0]
    if n_total == 0:
        return np.empty(0, dtype=np.int64)
    block = max(block, max_wave)
    if exact_budget is None:
        # generous: a completed closure buys exact (maximal) waves, and the
        # per-block cost is bounded by the budget either way
        exact_budget = max(131072, 16 * block * max(g.m // max(g.n, 1), 1))
    indptr = g.indptr.astype(np.int64)
    indices = g.indices.astype(np.int64)
    scratch = np.zeros((g.n, bitset.n_words(block)), dtype=np.uint64)
    iv = intervals
    blown = 0

    lengths: list = []
    i = 0
    while i < n_total:
        c = min(block, n_total - i)
        while True:
            if c == 1:
                lengths.append(1)  # a lone vertex is trivially a wave
                i += 1
                break
            cand = order[i : i + c]
            if iv is not None and blown >= _BLOW_LIMIT:
                conflict = _interval_conflicts(iv[0], iv[1], cand)
            else:
                conflict = _exact_conflicts(indptr, indices, cand, scratch, exact_budget)
                if conflict is None:  # budget blown: a huge cone is in range
                    blown += 1
                    if blown >= _BLOW_LIMIT:
                        # closure-hostile graph — switch every remaining
                        # fallback to the interval certificate
                        if iv is None:
                            iv = dfs_intervals(g, n_traversals)
                        c = min(c, max_wave)  # keep interval matrices small
                        continue
                    c = c // 2  # bisect: isolate the hub into a small block
                    continue
            _block_waves(conflict, c, max_wave, lengths)
            i += c
            break
        if abort_below_avg is not None and i >= 4096 and i / len(lengths) < abort_below_avg:
            return None
    return np.asarray(lengths, dtype=np.int64)


# ---------------------------------------------------------------------------
# one-pass rank-windowed scheduler
# ---------------------------------------------------------------------------


class _OnePassState:
    """Sliding-window closure state for ``wave_schedule`` (onepass).

    Candidates are seeded in *pages* of ``page`` consecutive ranks.  Rank p
    owns slot ``(p // page) % 2 * page + p % page`` — two pages of slots
    alternate, and because a wave (<= max_wave <= page members) never looks
    more than one page ahead of its start, at most two consecutive pages are
    ever live.  Page k's bits are cleared from its touched vertices exactly
    when page k+2 (same parity) is about to seed.
    """

    def __init__(self, g: CSRGraph, order: np.ndarray, page: int,
                 exact_budget: int, n_traversals: int,
                 intervals: Optional[Tuple[np.ndarray, np.ndarray]],
                 blow_limit: int = _BLOW_LIMIT, use_intervals: bool = True,
                 keep_raw: bool = False):
        self.g = g
        self.order = order
        self.page = page
        # speculative-schedule mode: a lower circuit breaker, no interval
        # fallback (optimistic waves don't need conservative certificates),
        # and raw (un-suffix-minned) pairs kept for wave annotations
        self.blow_limit = blow_limit
        self.use_intervals = use_intervals
        self.keep_raw = keep_raw
        self.raw: dict = {}  # page -> (lo sorted, hi) raw pairs | "dense" | None
        self.n_total = order.shape[0]
        self.k_words = bitset.n_words(2 * page)
        self.budget = exact_budget
        self.n_traversals = n_traversals
        self.indptr = g.indptr.astype(np.int64)
        self.indices = g.indices.astype(np.int64)
        # one CONTIGUOUS scratch per slot parity: the propagation sweep runs
        # at the blocked scheduler's mask width and never pays strided access
        half = self.k_words // 2
        self.scr = [
            np.zeros((g.n, half), dtype=np.uint64),
            np.zeros((g.n, half), dtype=np.uint64),
        ]
        # rank p's bits could not be propagated (budget blown) — the carve
        # treats p as conflicting per the interval certificate (or with
        # everything, before the circuit breaker pays for intervals)
        self.unknown = np.zeros(self.n_total, dtype=bool)
        self.touched: dict[int, list] = {}
        self.pairs: dict = {}  # page -> (lo sorted, suffix-min hi) or None
        self.iv = intervals
        self.blown = 0
        self.propagated = -1  # highest fully-seeded page

    # -- slot helpers ----------------------------------------------------

    def slots_of(self, ranks: np.ndarray) -> np.ndarray:
        return (ranks // self.page) % 2 * self.page + ranks % self.page

    # -- page lifecycle --------------------------------------------------

    def ensure_page(self, k: int) -> None:
        """Seed+propagate pages up to ``k`` (recycling dead slots first)."""
        while self.propagated < k:
            nxt = self.propagated + 1
            dead = nxt - 2
            if dead >= 0:
                t = self.touched.pop(dead, None)
                if t:  # a parity's scratch holds exactly one page's bits
                    self.scr[dead % 2][np.concatenate(t)] = 0
                self.pairs.pop(dead, None)
                self.raw.pop(dead, None)
            lo = nxt * self.page
            hi = min(lo + self.page, self.n_total)
            if lo < hi:
                self._propagate_range(np.arange(lo, hi, dtype=np.int64), nxt)
                self._extract_page_pairs(nxt)
            self.propagated = nxt

    def _propagate_range(self, ranks: np.ndarray, page_idx: int) -> None:
        """Propagate the closure bits of ``order[ranks]`` (one page or a
        bisected sub-range) through their cones: the budget-bounded
        multi-source sweep of ``_exact_conflicts``, but writing into the
        PERSISTENT sliding-window scratch — the bits are written once, read
        by every carve window that overlaps them, and no dense per-block
        conflict-matrix extraction (``masks_to_matrix``, the blocked
        scheduler's hottest line on overlap-heavy tree graphs) ever runs:
        ``_extract_page_pairs`` peels the set bits into sparse pair lists
        once per page."""
        if self.blown >= self.blow_limit:
            # closure-hostile graph: stop paying for closures, certify the
            # rest through the intervals (paid for once below).  In
            # speculative mode there is nothing to certify — unknown ranks
            # just ride in optimistic waves — so skip the interval DFS too.
            if self.iv is None and self.use_intervals:
                self.iv = dfs_intervals(self.g, self.n_traversals)
            self.unknown[ranks] = True
            return
        cands = self.order[ranks]
        half = self.k_words // 2
        q = page_idx % 2
        view = self.scr[q]
        sl = self.slots_of(ranks) - q * self.page  # page-local slot ids
        mbits = np.zeros((ranks.shape[0], half), dtype=np.uint64)
        mbits[np.arange(ranks.shape[0]), sl // 64] = _U64_ONE << (sl % 64).astype(np.uint64)
        view[cands] |= mbits
        touched = [cands]
        frontier, fbits = cands, mbits
        edges = 0
        ok = True
        while frontier.size:
            edges += int((self.indptr[frontier + 1] - self.indptr[frontier]).sum())
            if edges > self.budget:
                ok = False
                break
            nbrs, seg = bitset.csr_gather(self.indptr, self.indices, frontier)
            if nbrs.shape[0] == 0:
                break
            uniq, obits = bitset.group_or(nbrs, fbits[seg])
            new = obits & ~view[uniq]
            keep = new.any(axis=1)
            frontier = uniq[keep]
            fbits = new[keep]
            view[frontier] |= fbits
            touched.append(frontier)
        if not ok:  # budget blown: a huge cone is in range — roll back
            #         exactly this range's slot bits (a bisect sibling may
            #         already have propagated into the same parity)
            bits = np.zeros(half, dtype=np.uint64)
            np.bitwise_or.at(bits, sl // 64, _U64_ONE << (sl % 64).astype(np.uint64))
            view[np.concatenate(touched)] &= ~bits
            self.blown += 1
            if ranks.shape[0] == 1:
                self.unknown[ranks] = True  # a lone hub: carve isolates it
                return
            mid = ranks.shape[0] // 2  # bisect, like the blocked scheduler
            self._propagate_range(ranks[:mid], page_idx)
            self._propagate_range(ranks[mid:], page_idx)
            return
        self.touched.setdefault(page_idx, []).append(np.concatenate(touched))

    # -- conflict reads --------------------------------------------------

    def _extract_page_pairs(self, k: int) -> None:
        """Pull page k's conflict pairs out of its scratch parity, ONCE.

        A conflict involving a slot of page k is a page-k bit sitting on the
        row of a candidate of pages k-1 .. k+1 (windows never span further).
        Stored as (lo sorted ascending, suffix-min of hi) in GLOBAL rank
        space, so every carve window overlapping the page reads them with a
        binary search instead of re-scanning scratch."""
        r0 = max((k - 1) * self.page, 0)
        r1 = min((k + 2) * self.page, self.n_total)
        row_ranks = np.arange(r0, r1, dtype=np.int64)
        sub = self.scr[k % 2][self.order[r0:r1]]  # [R, K/2]
        # a page carrying > 64 conflicts per candidate is unbatchable — its
        # true waves are ~1 long regardless — so skip the (expensive)
        # extraction and let the carve treat the whole page conservatively
        # (hostile citeseerx-style graphs hit this on every page; the auto
        # probe then aborts without paying for exact pair lists)
        if int(bitset.popcount_u64(sub).sum()) > 64 * self.page:
            self.pairs[k] = "dense"
            if self.keep_raw:
                self.raw[k] = "dense"
            return
        a_out, b_out = [], []
        base = k * self.page
        for w in range(sub.shape[1]):
            act = np.flatnonzero(sub[:, w])
            vv = sub[act, w]
            it = 0
            # peel set bits lowest-first (cost tracks the conflict count);
            # rows still active after a few peels are dense — unpack those
            while act.size:
                if it >= 4:
                    bits = np.unpackbits(
                        np.ascontiguousarray(vv[:, None]).view(np.uint8),
                        axis=1, bitorder="little",
                    )
                    r, c = np.nonzero(bits)
                    a_out.append(base + w * 64 + c)
                    b_out.append(row_ranks[act[r]])
                    break
                low = vv & (~vv + _U64_ONE)
                a_out.append(base + w * 64 + bitset.popcount_u64(low - _U64_ONE))
                b_out.append(row_ranks[act])
                vv ^= low
                keep = vv != 0
                act, vv = act[keep], vv[keep]
                it += 1
        if not a_out:
            self.pairs[k] = None
            return
        a = np.concatenate(a_out).astype(np.int64)
        b = np.concatenate(b_out)
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        keep = lo != hi  # self-bits land on the diagonal
        if not keep.any():
            self.pairs[k] = None
            return
        o = np.argsort(lo[keep], kind="stable")
        lo_s = lo[keep][o]
        hi_s = hi[keep][o]
        self.pairs[k] = (lo_s, np.minimum.accumulate(hi_s[::-1])[::-1])
        if self.keep_raw:  # actual pairs, pre suffix-min: wave annotations
            self.raw[k] = (lo_s, hi_s)

    def min_break(self, s: int) -> int:
        """Smallest global rank b such that some pair (a, b) has a >= s —
        the wave starting at rank s must end before b.  A "dense" page's
        pairs were never extracted: conservatively, no wave crosses into it
        and waves inside it have length 1 (sound; such pages carve to
        single-member waves under exact pairs too)."""
        out = self.n_total
        for k in (s // self.page, s // self.page + 1):
            pr = self.pairs.get(k)
            if pr is None:
                continue
            if isinstance(pr, str):  # dense marker
                start = k * self.page
                out = min(out, start if start > s else s + 1)
                continue
            lo_s, smin = pr
            i = int(np.searchsorted(lo_s, s))
            if i < lo_s.size:
                out = min(out, int(smin[i]))
        return out

    def unknown_pairs(self, pos: int, limit: int):
        """(lo sorted, suffix-min hi) of window-LOCAL pairs contributed by
        unknown candidates (blown closures) — interval-certified when the
        circuit breaker has paid for the intervals, conflict-with-everyone
        otherwise.  None when the window has no unknown candidates."""
        ranks = np.arange(pos, pos + limit, dtype=np.int64)
        u = np.flatnonzero(self.unknown[ranks])
        if u.size == 0:
            return None
        if self.iv is not None:
            civ = _interval_conflicts(self.iv[0], self.iv[1], self.order[ranks])
            r, c = np.nonzero(civ[u])
            a, b = u[r], c
        else:
            a = np.repeat(u, limit)
            b = np.tile(np.arange(limit, dtype=np.int64), u.size)
        lo = np.minimum(a, b) + pos
        hi = np.maximum(a, b) + pos
        keep = lo != hi
        if not keep.any():
            return None
        o = np.argsort(lo[keep], kind="stable")
        lo_s = lo[keep][o]
        hi_s = hi[keep][o]
        return lo_s, np.minimum.accumulate(hi_s[::-1])[::-1]


_U64_ONE = np.uint64(1)


def wave_schedule(
    g: CSRGraph,
    order: np.ndarray,
    max_wave: int = 256,
    block: int = 256,
    n_traversals: int = 2,
    intervals: Tuple[np.ndarray, np.ndarray] | None = None,
    exact_budget: Optional[int] = None,
    abort_below_avg: Optional[float] = None,
    scheduler: str = "onepass",
) -> Optional[np.ndarray]:
    """Partition ``order`` into consecutive waves of mutually unreachable
    vertices.  Returns int64[n_waves] wave lengths (summing to len(order));
    wave k covers order[sum(lengths[:k]) : sum(lengths[:k+1])].

    ``scheduler="onepass"`` (default): the rank-windowed one-pass scheduler
    (module docstring) — the conflict relation is computed once per build
    and reused across every window that overlaps it; waves are maximal runs
    capped only by ``max_wave``, never by block boundaries.
    ``scheduler="blocked"``: the per-block closure scheduler
    (``wave_schedule_blocked``), whose waves additionally truncate at
    ``block`` boundaries.

    ``abort_below_avg``: probe mode — once ~4k vertices are scheduled, give
    up and return None if the mean wave is below the threshold (the caller
    will not profit from batching; don't pay for the full schedule).
    """
    if scheduler in ("blocked", "per-block"):
        return wave_schedule_blocked(
            g, order, max_wave=max_wave, block=block, n_traversals=n_traversals,
            intervals=intervals, exact_budget=exact_budget,
            abort_below_avg=abort_below_avg,
        )
    if scheduler != "onepass":
        raise ValueError(f"unknown scheduler {scheduler!r}")
    order = np.asarray(order, dtype=np.int64)
    n_total = order.shape[0]
    if n_total == 0:
        return np.empty(0, dtype=np.int64)
    # word-aligned pages: each page's slots fill a contiguous uint64 half of
    # the scratch row (the propagation sweep runs on that half only)
    page = -(-max(block, max_wave) // 64) * 64
    if exact_budget is None:
        exact_budget = max(131072, 16 * page * max(g.m // max(g.n, 1), 1))
    state = _OnePassState(g, order, page, exact_budget, n_traversals, intervals)

    lengths: list = []
    pos = 0
    while pos < n_total:
        # read one conflict window spanning at most the two live pages and
        # carve as many waves out of it as fit — consecutive windows overlap
        # heavily when waves are short, so the read is amortized
        win = min(2 * page - pos % page, n_total - pos)
        state.ensure_page((pos + win - 1) // page)
        upairs = state.unknown_pairs(pos, win)
        off = 0
        while off < win:
            s = pos + off
            limit = min(max_wave, win - off)
            # a wave starting at s ends before the smallest b over pairs
            # (a, b) with a >= s — one binary search per live page
            b_min = state.min_break(s)
            if upairs is not None:
                lo_s, smin = upairs
                i = int(np.searchsorted(lo_s, s))
                if i < lo_s.size:
                    b_min = min(b_min, int(smin[i]))
            wlen = min(b_min - s, limit)
            if wlen == limit and limit < min(max_wave, n_total - s):
                break  # window-truncated, not conflict- or cap-ended: re-read
            wlen = max(wlen, 1)
            lengths.append(wlen)
            off += wlen
        pos += off
        if abort_below_avg is not None and pos >= 4096 and pos / len(lengths) < abort_below_avg:
            return None
    return np.asarray(lengths, dtype=np.int64)


# ---------------------------------------------------------------------------
# speculative (optimistic) scheduler
# ---------------------------------------------------------------------------


class SpecSchedule:
    """An optimistic wave partition: exact waves where the closure proved
    mutual unreachability, max-size *speculative* chunks everywhere else.

    ``lengths`` int64[n_waves] — consecutive rank runs summing to len(order).
    ``optimistic`` bool[n_waves] — False: proven conflict-free (the engine
    runs the plain exact sweep, no certification); True: unproven (the
    engine must certify the sweep and roll back / replay violations).
    ``pairs`` — per-wave annotation: None for exact waves; for optimistic
    waves either an int64[p, 2] array of wave-local intra-wave reach pairs
    the windowed closure already computed (advisory: the certification pass
    derives the true violation set from the sweep itself) or ``"unknown"``
    when the closure budget blew / the page was conflict-dense.
    """

    __slots__ = ("lengths", "optimistic", "pairs", "meta")

    def __init__(self, lengths, optimistic, pairs, meta):
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.optimistic = np.asarray(optimistic, dtype=bool)
        self.pairs = pairs
        self.meta = meta


def speculative_schedule(
    g: CSRGraph,
    order: np.ndarray,
    max_wave: int = 256,
    block: int = 256,
    spec_below: int = 24,
    exact_budget: Optional[int] = None,
    blow_limit: int = 8,
) -> SpecSchedule:
    """Optimistically partition ``order``: exact waves where they are long
    enough to amortize the batched sweep, rank-consecutive speculative
    chunks everywhere else.

    Reuses the one-pass windowed closure machinery, but in a cheap mode
    tuned for dense-reachability graphs — the exact scheduler's failure
    case: the closure budget is capped at ~m/4 edges (a page whose cones
    swallow the whole graph aborts fast instead of completing a useless
    whole-graph propagation), the circuit breaker trips after
    ``blow_limit`` blown closures, and no DFS-interval certificate is ever
    computed (unknown ranks simply ride in optimistic chunks — the engine's
    certification pass, not the scheduler, is the safety net).  Where
    propagation did complete, its conflict pairs carve exact waves for
    free; runs shorter than ``spec_below`` are merged into optimistic
    chunks and annotated with the intra-wave reach pairs already computed.
    """
    order = np.asarray(order, dtype=np.int64)
    n_total = order.shape[0]
    if n_total == 0:
        return SpecSchedule(np.empty(0, np.int64), np.empty(0, bool), [], {})
    page = -(-max(block, max_wave) // 64) * 64
    if exact_budget is None:
        exact_budget = min(
            max(131072, 16 * page * max(g.m // max(g.n, 1), 1)),
            max(g.m // 4, 8192),
        )
    state = _OnePassState(
        g, order, page, exact_budget, 2, None,
        blow_limit=blow_limit, use_intervals=False, keep_raw=True,
    )

    def _chunk_pairs(s: int, wlen: int):
        """Wave-local intra-wave pairs of [s, s+wlen), or "unknown"."""
        if state.unknown[s : s + wlen].any():
            return "unknown"
        a_out, b_out = [], []
        for k in range(s // page, (s + wlen - 1) // page + 1):
            pr = state.raw.get(k)
            if pr is None:
                continue
            if isinstance(pr, str):  # dense marker: pairs never extracted
                return "unknown"
            lo_s, hi_s = pr
            sel = (lo_s >= s) & (hi_s < s + wlen)
            if sel.any():
                a_out.append(lo_s[sel])
                b_out.append(hi_s[sel])
        if not a_out:
            return np.empty((0, 2), dtype=np.int64)
        return np.stack([np.concatenate(a_out) - s, np.concatenate(b_out) - s], axis=1)

    lengths: list = []
    optimistic: list = []
    pairs: list = []
    pos = 0
    while pos < n_total:
        win = min(2 * page - pos % page, n_total - pos)
        state.ensure_page((pos + win - 1) // page)
        off = 0
        while off < win:
            s = pos + off
            limit = min(max_wave, win - off)
            # longest exact wave from s: bounded by the first conflict pair
            # and the first budget-blown (unknown) rank at or after s
            b_min = state.min_break(s)
            unk = state.unknown[s : s + limit]
            if unk.any():
                b_min = min(b_min, s + int(np.argmax(unk)))
            wlen = min(b_min - s, limit)
            if wlen == limit and limit < min(max_wave, n_total - s):
                break  # window-truncated, not conflict-ended: re-read
            if wlen >= min(spec_below, n_total - s):
                lengths.append(wlen)
                optimistic.append(False)
                pairs.append(None)
            else:  # too short to amortize: speculate a full chunk instead
                if limit < min(max_wave, n_total - s):
                    break  # window tail: re-read so the chunk is full-size
                wlen = limit
                lengths.append(wlen)
                optimistic.append(True)
                pairs.append(_chunk_pairs(s, wlen))
            off += wlen
        pos += off
    opt = np.asarray(optimistic, dtype=bool)
    lens = np.asarray(lengths, dtype=np.int64)
    meta = {
        "n_waves": int(lens.shape[0]),
        "n_optimistic": int(opt.sum()),
        "optimistic_frac": float(lens[opt].sum() / max(n_total, 1)),
        "closures_blown": int(state.blown),
    }
    return SpecSchedule(lens, opt, pairs, meta)
