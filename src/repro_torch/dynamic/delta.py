"""Edge-update log + incremental SCC-condensation maintenance.

The static pipeline condenses SCCs once (``graph/scc.py``) and labels the
resulting DAG.  Under live edge updates the condensation itself mutates:

  * an insertion (u, v) whose condensation endpoints already reach back
    (cv ->* cu) closes a cycle — every condensation vertex on a cv ~> cu
    path collapses **in place** into one SCC (the representative keeps its
    id; absorbed ids become dead, empty vertices so label rows and ranks
    stay index-stable),
  * a deletion inside an SCC may split it — a **scoped** re-check runs
    Tarjan (``graph/scc.py``) on the induced subgraph of that SCC's members
    only, never the whole graph; split parts get fresh condensation ids.

Everything else is a plain DAG edge event: insertions/deletions between
distinct comps adjust a per-condensation-edge multiplicity (several original
edges can back one DAG edge) and only surface to the label layer when a DAG
edge actually appears or disappears.  ``CondensationState.apply`` returns
one ``DeltaEvent`` per update so ``repro_torch.dynamic.versioned`` can route:
``dag_insert``/``dag_delete`` -> incremental label repair (``repair.py``),
``merge``/``split`` (structural=True) -> compacting rebuild.

The counterpart of ``repro.dynamic.delta``, a copy (numpy and Python sets
only).  The sets and the order of every operation are ``repro``'s: the label
repairs walk ``dag_out``/``dag_in`` in set order, and that order decides
which labels come out, so the two packages' labels agree byte for byte.
``UpdateBatch.of`` orders every insert before every delete; a caller whose
updates touch one edge twice builds the ordered ``UpdateBatch`` itself.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Set, Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph, from_edges
from repro_torch.graph.scc import tarjan_scc

# event kinds
NOOP = "noop"
DAG_INSERT = "dag_insert"   # new condensation edge, still a DAG -> repairable
DAG_DELETE = "dag_delete"   # condensation edge vanished            -> repairable
MERGE = "merge"             # insertion closed a cycle              -> structural
SPLIT = "split"             # deletion split an SCC                 -> structural


@dataclasses.dataclass(frozen=True)
class EdgeUpdate:
    """One logged update in ORIGINAL vertex space."""
    insert: bool
    u: int
    v: int


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """An ordered batch of edge updates (the unit of apply/publish)."""
    updates: Tuple[EdgeUpdate, ...]

    def __len__(self) -> int:
        return len(self.updates)

    @staticmethod
    def of(inserts: Iterable[Tuple[int, int]] = (),
           deletes: Iterable[Tuple[int, int]] = ()) -> "UpdateBatch":
        ups = [EdgeUpdate(True, int(u), int(v)) for u, v in inserts]
        ups += [EdgeUpdate(False, int(u), int(v)) for u, v in deletes]
        return UpdateBatch(tuple(ups))


@dataclasses.dataclass(frozen=True)
class DeltaEvent:
    """What one edge update did to the condensation."""
    kind: str
    cu: int = -1            # condensation endpoints (dag_insert / dag_delete)
    cv: int = -1
    merged: Tuple[int, ...] = ()   # comp ids collapsed (merge)
    split_into: Tuple[int, ...] = ()  # comp ids after a split

    @property
    def structural(self) -> bool:
        return self.kind in (MERGE, SPLIT)


class CondensationState:
    """Mutable SCC condensation of a digraph under edge updates.

    Original-graph adjacency lives in python sets (the update log's working
    form); the condensation is comp ids + DAG adjacency sets + per-DAG-edge
    multiplicities.  Comp ids are index-stable: merges keep the
    representative's id and leave absorbed ids dead (no members, no edges);
    splits append fresh ids.  ``dag_csr()`` materializes the current DAG for
    rebuilds; dead ids come out isolated and never receive queries because
    ``comp`` never points at them.
    """

    def __init__(self, g: CSRGraph):
        self.n_orig = g.n
        # python-int copies of the CSR and the comp map: the loops below are
        # repro's, in its order, without a numpy scalar per element
        ptr, idx = g.indptr.tolist(), g.indices.tolist()
        self.out_adj: List[Set[int]] = [set(idx[ptr[v]:ptr[v + 1]])
                                        for v in range(g.n)]
        self.in_adj: List[Set[int]] = [set() for _ in range(g.n)]
        for u in range(g.n):
            for w in self.out_adj[u]:
                self.in_adj[w].add(u)
        comp, k = tarjan_scc(g)
        self.comp = comp.astype(np.int32).copy()
        self.n_comp = int(k)
        comp = self.comp.tolist()
        self.members: List[List[int]] = [[] for _ in range(k)]
        for v in range(g.n):
            self.members[comp[v]].append(v)
        self.dead: Set[int] = set()
        self.edge_mult: Dict[Tuple[int, int], int] = {}
        for u in range(g.n):
            cu = comp[u]
            for w in self.out_adj[u]:
                cw = comp[w]
                if cu != cw:
                    key = (cu, cw)
                    self.edge_mult[key] = self.edge_mult.get(key, 0) + 1
        self.dag_out: List[Set[int]] = [set() for _ in range(k)]
        self.dag_in: List[Set[int]] = [set() for _ in range(k)]
        for (a, b) in self.edge_mult:
            self.dag_out[a].add(b)
            self.dag_in[b].add(a)

    # ------------------------------------------------------------ queries

    @property
    def n_live(self) -> int:
        return self.n_comp - len(self.dead)

    def dag_m(self) -> int:
        return len(self.edge_mult)

    def dag_csr(self) -> CSRGraph:
        """Materialize the current condensation DAG (dead ids isolated)."""
        if self.edge_mult:
            src, dst = zip(*self.edge_mult.keys())
        else:
            src, dst = (), ()
        return from_edges(self.n_comp, np.asarray(src, dtype=np.int64),
                          np.asarray(dst, dtype=np.int64))

    # ------------------------------------------------------- serialization

    def to_arrays(self) -> Tuple[Dict[str, np.ndarray], dict]:
        """Exact state as (named arrays, meta) for ``repro_torch.persist``.

        Only the irreducible state is saved: the original edge list, the
        comp map, the members lists (in live order — future split id
        assignments depend on it), and the DAG edge multiplicities.
        ``in_adj``, ``dag_out``/``dag_in`` and ``dead`` are derived on load
        (dead ids are exactly the memberless ones)."""
        from repro_torch.persist.blocks import concat_rows, pack_ragged, row_lengths

        # repro's arrays, built in bulk: a vertex id per out-edge, each
        # vertex's targets sorted, and the multiplicities sorted by key
        lens = row_lengths(self.out_adj)
        src = np.repeat(np.arange(self.n_orig, dtype=np.int64), lens)
        dst = concat_rows(self.out_adj, np.int64, sorted)
        mem_vals, mem_offs = pack_ragged(self.members, dtype=np.int64)
        if self.edge_mult:
            em = np.fromiter(
                itertools.chain.from_iterable((a, b, c) for (a, b), c in self.edge_mult.items()),
                dtype=np.int64, count=3 * len(self.edge_mult)).reshape(-1, 3)
            em = em[np.lexsort((em[:, 1], em[:, 0]))]
        else:
            em = np.empty((0, 3), dtype=np.int64)
        arrays = {
            "edges_src": src, "edges_dst": dst,
            "comp": self.comp, "members_vals": mem_vals,
            "members_offs": mem_offs, "edge_mult": em,
        }
        return arrays, {"n_orig": self.n_orig, "n_comp": self.n_comp}

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray], meta: dict) -> "CondensationState":
        """Rebuild the exact state saved by ``to_arrays`` — no Tarjan run
        (a fresh SCC pass could assign different comp ids than the
        incrementally maintained ones the saved labels are written in)."""
        self = object.__new__(cls)
        self.n_orig = int(meta["n_orig"])
        self.out_adj = [set() for _ in range(self.n_orig)]
        self.in_adj = [set() for _ in range(self.n_orig)]
        for u, w in zip(arrays["edges_src"].tolist(), arrays["edges_dst"].tolist()):
            self.out_adj[u].add(w)
            self.in_adj[w].add(u)
        self.comp = np.asarray(arrays["comp"], dtype=np.int32).copy()
        self.n_comp = int(meta["n_comp"])
        from repro_torch.persist.blocks import unpack_ragged

        self.members = unpack_ragged(arrays["members_vals"], arrays["members_offs"])
        self.dead = {c for c in range(self.n_comp) if not self.members[c]}
        self.edge_mult = {
            (a, b): c for a, b, c in np.asarray(arrays["edge_mult"]).tolist()}
        self.dag_out = [set() for _ in range(self.n_comp)]
        self.dag_in = [set() for _ in range(self.n_comp)]
        for (a, b) in self.edge_mult:
            self.dag_out[a].add(b)
            self.dag_in[b].add(a)
        return self

    def _dag_reaches(self, a: int, b: int) -> bool:
        """BFS a ->* b over the condensation (scoped cycle probe)."""
        if a == b:
            return True
        seen = {a}
        stack = [a]
        while stack:
            x = stack.pop()
            for y in self.dag_out[x]:
                if y == b:
                    return True
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return False

    def _cone(self, root: int, adj: List[Set[int]]) -> Set[int]:
        """Reflexive closure of ``root`` under ``adj`` (descendants for
        dag_out, ancestors for dag_in)."""
        seen = {root}
        stack = [root]
        while stack:
            x = stack.pop()
            for y in adj[x]:
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return seen

    # ------------------------------------------------------------ updates

    def apply(self, batch: UpdateBatch) -> List[DeltaEvent]:
        return [self.insert(up.u, up.v) if up.insert else self.delete(up.u, up.v)
                for up in batch.updates]

    def insert(self, u: int, v: int) -> DeltaEvent:
        u, v = int(u), int(v)
        if u == v or v in self.out_adj[u]:
            return DeltaEvent(NOOP)
        self.out_adj[u].add(v)
        self.in_adj[v].add(u)
        cu, cv = int(self.comp[u]), int(self.comp[v])
        if cu == cv:
            return DeltaEvent(NOOP)  # intra-SCC edge: condensation unchanged
        key = (cu, cv)
        if key in self.edge_mult:
            self.edge_mult[key] += 1
            return DeltaEvent(NOOP)  # DAG edge already present
        if self._dag_reaches(cv, cu):
            # the new edge closes a cycle: every comp on a cv ~> cu path
            # joins one SCC.  S = desc(cv) cap anc(cu) (reflexive), computed
            # before wiring the new edge in.
            S = self._cone(cv, self.dag_out) & self._cone(cu, self.dag_in)
            S.add(cu)
            S.add(cv)
            self.edge_mult[key] = 1
            self.dag_out[cu].add(cv)
            self.dag_in[cv].add(cu)
            rep = self._merge(S)
            return DeltaEvent(MERGE, cu=rep, merged=tuple(sorted(S)))
        self.edge_mult[key] = 1
        self.dag_out[cu].add(cv)
        self.dag_in[cv].add(cu)
        return DeltaEvent(DAG_INSERT, cu=cu, cv=cv)

    def delete(self, u: int, v: int) -> DeltaEvent:
        u, v = int(u), int(v)
        if u == v or v not in self.out_adj[u]:
            return DeltaEvent(NOOP)
        self.out_adj[u].discard(v)
        self.in_adj[v].discard(u)
        cu, cv = int(self.comp[u]), int(self.comp[v])
        if cu != cv:
            key = (cu, cv)
            self.edge_mult[key] -= 1
            if self.edge_mult[key] > 0:
                return DeltaEvent(NOOP)  # other original edges still back it
            del self.edge_mult[key]
            self.dag_out[cu].discard(cv)
            self.dag_in[cv].discard(cu)
            return DeltaEvent(DAG_DELETE, cu=cu, cv=cv)
        # intra-SCC deletion: scoped re-check of THIS component only
        return self._recheck_scc(cu)

    # --------------------------------------------------------- structural

    def _merge(self, S: Set[int]) -> int:
        """Collapse comps ``S`` in place; the smallest id is representative."""
        rep = min(S)
        for c in S:
            if c == rep:
                continue
            for ov in self.members[c]:
                self.comp[ov] = rep
            self.members[rep].extend(self.members[c])
            self.members[c] = []
            self.dead.add(c)
        # remap condensation edges touching S
        moved: Dict[Tuple[int, int], int] = {}
        for (a, b) in list(self.edge_mult.keys()):
            if a in S or b in S:
                cnt = self.edge_mult.pop((a, b))
                a2 = rep if a in S else a
                b2 = rep if b in S else b
                if a2 != b2:
                    moved[(a2, b2)] = moved.get((a2, b2), 0) + cnt
                self.dag_out[a].discard(b)
                self.dag_in[b].discard(a)
        for (a, b), cnt in moved.items():
            self.edge_mult[(a, b)] = self.edge_mult.get((a, b), 0) + cnt
            self.dag_out[a].add(b)
            self.dag_in[b].add(a)
        return rep

    def _recheck_scc(self, c: int) -> DeltaEvent:
        """Tarjan on the induced subgraph of comp ``c``'s members."""
        mem = self.members[c]
        if len(mem) <= 1:
            return DeltaEvent(NOOP)
        local = {ov: i for i, ov in enumerate(mem)}
        src, dst = [], []
        for ov in mem:
            li = local[ov]
            for w in self.out_adj[ov]:
                lj = local.get(w)
                if lj is not None:
                    src.append(li)
                    dst.append(lj)
        sub = from_edges(len(mem), np.asarray(src, dtype=np.int64),
                         np.asarray(dst, dtype=np.int64))
        lcomp, lk = tarjan_scc(sub)
        if lk == 1:
            return DeltaEvent(NOOP)  # still strongly connected
        # split: local comp 0 keeps id c, the rest get fresh ids
        new_ids = [c] + list(range(self.n_comp, self.n_comp + lk - 1))
        self.n_comp += lk - 1
        for _ in range(lk - 1):
            self.members.append([])
            self.dag_out.append(set())
            self.dag_in.append(set())
        groups: List[List[int]] = [[] for _ in range(lk)]
        for i, ov in enumerate(mem):
            groups[int(lcomp[i])].append(ov)
        for gi, group in enumerate(groups):
            cid = new_ids[gi]
            self.members[cid] = group
            for ov in group:
                self.comp[ov] = cid
        # recompute condensation edges incident to the old component: drop
        # everything touching c, then re-derive from the members' original
        # edges (intra-SCC edges may now cross sub-comps, and old cross
        # edges re-attach to the right sub-comp)
        for (a, b) in list(self.edge_mult.keys()):
            if a == c or b == c:
                del self.edge_mult[(a, b)]
                self.dag_out[a].discard(b)
                self.dag_in[b].discard(a)
        touched: Dict[Tuple[int, int], int] = {}
        for ov in mem:
            co = int(self.comp[ov])
            for w in self.out_adj[ov]:
                cw = int(self.comp[w])
                if cw != co:
                    touched[(co, cw)] = touched.get((co, cw), 0) + 1
            for w in self.in_adj[ov]:
                if w in local:
                    continue  # member->member edges were counted above
                cw = int(self.comp[w])
                touched[(cw, co)] = touched.get((cw, co), 0) + 1
        for (a, b), cnt in touched.items():
            self.edge_mult[(a, b)] = self.edge_mult.get((a, b), 0) + cnt
            self.dag_out[a].add(b)
            self.dag_in[b].add(a)
        return DeltaEvent(SPLIT, cu=c, split_into=tuple(new_ids))
