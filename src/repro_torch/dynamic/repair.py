"""Incremental label repair under DAG edge updates (the §5.2 resume).

Labels here are the same 2-hop rows the static builder produces, held in a
mutable working form between published epochs.  Both repairs distribute hops
through ``repro_torch.build.engine.cone_resume_sweep`` — the cone-scoped
resumption of Algorithm 2's pruned BFS — with the prune probe restricted to
ranks at least as high as the hop being distributed, so every verdict
matches what the sequential construction loop would have produced and the
repaired labels stay non-redundant (Theorem 4) up to covers created by
later updates.

Insert (u, v), DAG-preserving
    New reachable pairs all factor as x ->* u -> v ->* y.  The highest-
    ranked vertex on any such path sits either in the x ->* u half — then it
    is already (canonically) in L_in(u) — or in the v ->* y half — then in
    L_out(v).  So it suffices to resume, in rank order:
      * each hop h in L_in(u): h's FORWARD sweep, seeded at v (h now reaches
        v's cone through the new edge),
      * each hop h in L_out(v): h's REVERSE sweep, seeded at u.
    Seeding with existing labels as the prune set keeps the sweeps inside
    the affected cone: a vertex whose pair with h is already covered prunes
    immediately.

Delete (u, v), DAG edge removed
    Only pairs x in A = anc(u), y in B = desc(v) can change, and label
    entries change only in the (row in A, hop in B) / (row in B, hop in A)
    pattern: any x -> h walk through the deleted edge needs x ->* u and
    v ->* h.  The repair therefore
      1. invalidates exactly those entries (found by masking rows of A/B
         against the cone's rank set — the witness tally says which hops are
         referenced at all, so unreferenced cones skip the scan), then
      2. re-distributes the affected hops in rank order: hop h in B re-runs
         its reverse sweep from h itself, hop h in A its forward sweep,
         interleaved ascending by rank so every prune probe reads labels
         that are already final for all higher ranks (exactly the state the
         static loop would have seen).
    Everything outside the pattern is untouched — those entries are provably
    canonical-stable under the deletion.

The counterpart of ``repro.dynamic.repair``, a copy: the loops and their
order are ``repro``'s, so repaired labels agree byte for byte.
"""
from __future__ import annotations

import bisect
import itertools
from typing import Dict, List, Set

import numpy as np

from repro_torch.build.engine import cone_resume_sweep


class MutableLabels:
    """Working (between-epochs) form of the oracle's label rows.

    Rank-space values in per-vertex sorted lists — the ragged
    ``_LabelStore`` layout without the dense matrix, because repairs touch a
    few rows at a time and publish copy-on-writes them back into the dense
    serving layout.  Tracks dirty rows for COW publish and a witness tally
    (per-hop reference counts) for the delete repair's invalidation scan and
    the repair-vs-rebuild cost signal.
    """

    def __init__(self, out_rows: List[List[int]], in_rows: List[List[int]]):
        self.n = len(out_rows)
        self.out_rows = out_rows
        self.in_rows = in_rows
        self.dirty_out: Set[int] = set()
        self.dirty_in: Set[int] = set()
        self.appends = 0
        self.drops = 0
        self._mark_appends = 0
        self._mark_drops = 0
        # witness tally: how many rows reference each hop rank
        self.tally_out = self._tally(out_rows)
        self.tally_in = self._tally(in_rows)

    def _tally(self, rows: List[List[int]]) -> np.ndarray:
        hops = np.fromiter(itertools.chain.from_iterable(rows), dtype=np.int64,
                           count=sum(map(len, rows)))
        return np.bincount(hops, minlength=self.n).astype(np.int64, copy=False)

    @classmethod
    def from_oracle(cls, oracle) -> "MutableLabels":
        """The rows ``row_out(v)`` / ``row_in(v)`` of every vertex as python
        lists, read in one pass over each matrix."""
        def rows(L, lens):
            flat = iter(L[np.arange(L.shape[1])[None, :] < lens[:, None]].tolist())
            return [list(itertools.islice(flat, k)) for k in lens.tolist()]

        return cls(rows(oracle.L_out, oracle.out_len), rows(oracle.L_in, oracle.in_len))

    # ------------------------------------------------------------- reads

    def _rows(self, side: str) -> List[List[int]]:
        return self.out_rows if side == "out" else self.in_rows

    def label_ints(self) -> int:
        return sum(len(r) for r in self.out_rows) + sum(len(r) for r in self.in_rows)

    def prune(self, vertex: int, hop: int, hop_vertex: int, side: str,
              include_equal: bool) -> bool:
        """Algorithm 2's prune probe, rank-restricted.

        side="out" (distributing ``hop`` into L_out(vertex)): a cover g with
        vertex ->* g ->* hop_vertex lives in L_out(vertex) cap
        L_in(hop_vertex).  side="in" mirrors it.  Only covers ranked at
        least as high as ``hop`` count (g < hop; g == hop means "already
        present" and prunes only when ``include_equal``).
        """
        if side == "out":
            a, b = self.out_rows[vertex], self.in_rows[hop_vertex]
        else:
            a, b = self.in_rows[vertex], self.out_rows[hop_vertex]
        limit = hop + 1 if include_equal else hop
        i = j = 0
        na, nb = len(a), len(b)
        while i < na and j < nb:
            x, y = a[i], b[j]
            if x >= limit or y >= limit:
                return False
            if x == y:
                return True
            if x < y:
                i += 1
            else:
                j += 1
        return False

    def has(self, side: str, vertex: int, hop: int) -> bool:
        row = self._rows(side)[vertex]
        k = bisect.bisect_left(row, hop)
        return k < len(row) and row[k] == hop

    # ------------------------------------------------------------ writes

    def add(self, side: str, vertex: int, hop: int) -> int:
        """Idempotent sorted insert; returns 1 if a value was appended."""
        row = self._rows(side)[vertex]
        k = bisect.bisect_left(row, hop)
        if k < len(row) and row[k] == hop:
            return 0
        row.insert(k, hop)
        (self.dirty_out if side == "out" else self.dirty_in).add(vertex)
        (self.tally_out if side == "out" else self.tally_in)[hop] += 1
        self.appends += 1
        return 1

    def drop_in_set(self, side: str, vertex: int, ranks: Set[int]) -> int:
        """Invalidate every entry of ``vertex`` whose value is in ``ranks``."""
        row = self._rows(side)[vertex]
        kept = [r for r in row if r not in ranks]
        dropped = len(row) - len(kept)
        if dropped:
            tally = self.tally_out if side == "out" else self.tally_in
            for r in row:
                if r in ranks:
                    tally[r] -= 1
            self._rows(side)[vertex][:] = kept
            (self.dirty_out if side == "out" else self.dirty_in).add(vertex)
            self.drops += dropped
        return dropped

    def epoch_counters(self) -> tuple[int, int]:
        """(appends, drops) accumulated since the previous call — the
        per-epoch churn window ``versioned.DynamicOracle`` logs so label
        growth (rank drift under churn) is measurable per publish."""
        a = self.appends - self._mark_appends
        d = self.drops - self._mark_drops
        self._mark_appends, self._mark_drops = self.appends, self.drops
        return a, d

    def peek_dirty(self) -> tuple[Dict[int, List[int]], Dict[int, List[int]]]:
        """Dirty rows since the last publish, WITHOUT consuming them — the
        transactional publish stages from this and calls ``clear_dirty``
        only at its commit point, so a failed publish stays retryable."""
        out = {v: list(self.out_rows[v]) for v in self.dirty_out}
        inn = {v: list(self.in_rows[v]) for v in self.dirty_in}
        return out, inn

    def clear_dirty(self) -> None:
        self.dirty_out = set()
        self.dirty_in = set()

    def take_dirty(self) -> tuple[Dict[int, List[int]], Dict[int, List[int]]]:
        """Dirty rows since the last publish (and reset the dirty sets)."""
        out, inn = self.peek_dirty()
        self.clear_dirty()
        return out, inn


def repair_insert(labels: MutableLabels, delta, inv_rank: np.ndarray,
                  cu: int, cv: int) -> int:
    """Repair labels after DAG edge (cu, cv) was inserted (no cycle).

    Resumes, in rank order (highest first), the forward sweep of every hop
    in L_in(cu) from seed cv and the reverse sweep of every hop in
    L_out(cv) from seed cu.  Self-entries make cu and cv themselves part of
    the resumed set.  Returns the number of label appends.
    """
    resumes = [(h, "in") for h in labels.in_rows[cu]]
    resumes += [(h, "out") for h in labels.out_rows[cv]]
    resumes.sort()
    fwd = delta.dag_out
    rev = delta.dag_in
    appended = 0
    for h, side in resumes:
        hv = int(inv_rank[h])
        if side == "in":
            # hop reaches cu, now reaches cv's cone: forward sweep from cv
            appended += cone_resume_sweep(
                lambda w: fwd[w], labels, h, hv, cv, "in", stop_at_present=True
            )
        else:
            # cv reaches hop, cu's cone now reaches it: reverse sweep from cu
            appended += cone_resume_sweep(
                lambda w: rev[w], labels, h, hv, cu, "out", stop_at_present=True
            )
    return appended


def repair_delete(labels: MutableLabels, delta, rank: np.ndarray,
                  inv_rank: np.ndarray, cu: int, cv: int,
                  max_cone: int) -> bool:
    """Repair labels after DAG edge (cu, cv) was deleted.

    Returns False when the affected cone exceeds ``max_cone`` vertices — the
    caller should fall back to a compacting rebuild (the repair-vs-rebuild
    crossover the staleness budget tracks).
    """
    A = delta._cone(cu, delta.dag_in)    # ancestors of u (reflexive)
    B = delta._cone(cv, delta.dag_out)   # descendants of v (reflexive)
    if len(A) + len(B) > max_cone:
        return False
    rank_A = {int(rank[x]) for x in A}
    rank_B = {int(rank[x]) for x in B}
    # 1. invalidate the (row in A, hop in B) / (row in B, hop in A) pattern.
    #    The witness tally bounds the scan: cones whose ranks are referenced
    #    nowhere can skip their rows entirely.
    if any(labels.tally_out[r] for r in rank_B):
        for x in A:
            labels.drop_in_set("out", x, rank_B)
    if any(labels.tally_in[r] for r in rank_A):
        for y in B:
            labels.drop_in_set("in", y, rank_A)
    # 2. re-distribute affected hops, both sides interleaved in rank order
    #    so every prune probe reads final labels for all higher ranks
    redo = sorted([(r, "out") for r in rank_B] + [(r, "in") for r in rank_A])
    fwd = delta.dag_out
    rev = delta.dag_in
    for h, side in redo:
        hv = int(inv_rank[h])
        if side == "out":
            # hop in B: its reverse sweep re-runs from the hop itself
            cone_resume_sweep(
                lambda w: rev[w], labels, h, hv, hv, "out", stop_at_present=False
            )
        else:
            cone_resume_sweep(
                lambda w: fwd[w], labels, h, hv, hv, "in", stop_at_present=False
            )
    return True
