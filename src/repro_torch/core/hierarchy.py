"""Hierarchical-Labeling (paper §4, Algorithm 1).

1. Recursive hierarchical DAG decomposition (Definition 2): G_0 = G,
   G_{i+1} = one-side reachability backbone of G_i, until the level graph is
   small (<= core_max vertices) or max_levels reached.
2. Label the core graph G_h completely (we use Distribution-Labeling; the
   paper allows "the existing 2-hop labeling" — any complete core labeling
   preserves Theorem 1's induction. Formula 3 is also provided for
   diameter <= eps cores).
3. Level-wise labeling from h-1 down to 0 (Formulas 4/5 with the L_in typo
   corrected: L_in inherits L_in of the incoming backbone set):

     L_out(v) = {v} u N1_out(v|G_i) u  U_{u in B_out(v)} L_out(u)
     L_in(v)  = {v} u N1_in(v|G_i)  u  U_{u in B_in(v)}  L_in(u)

All hop ids in the final labels are global (G_0) vertex ids.

The counterpart of ``repro.core.hierarchy``: the same loops in the same
order, so the labels are byte-identical to the JAX package's.  The core is
labelled by the port's Distribution-Labeling build (on ``device`` when its
``impl="auto"`` picks the device engine; a core of at most ``core_max``
vertices builds on the host).  ``build_stats`` records the level sizes and
the seconds of the three stages: ``decompose``, ``core`` and ``levelwise``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np

from repro_torch.build import bitset
from repro_torch.build.traverse import batched_union_rows, khop_out as _khop_out
from repro_torch.core.backbone import Backbone, one_side_backbone
from repro_torch.core.distribution import distribution_labeling
from repro_torch.core.oracle import ReachabilityOracle, finalize_labels
from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class Hierarchy:
    """levels[i] = graph G_i with vertex ids local to level i;
    to_global[i][local_id] = global (G_0) vertex id."""

    levels: List[CSRGraph]
    to_global: List[np.ndarray]
    backbones: List[Backbone]  # backbones[i] maps G_i -> G_{i+1}

    @property
    def h(self) -> int:
        return len(self.levels) - 1


def decompose(g: CSRGraph, eps: int = 2, core_max: int = 1024, max_levels: int = 10) -> Hierarchy:
    levels = [g]
    to_global = [np.arange(g.n, dtype=np.int32)]
    backbones: List[Backbone] = []
    while levels[-1].n > core_max and len(levels) - 1 < max_levels:
        bb = one_side_backbone(levels[-1], eps)
        if bb.vstar.shape[0] == 0 or bb.vstar.shape[0] >= levels[-1].n:
            break  # no reduction possible — stop decomposing
        backbones.append(bb)
        levels.append(bb.graph)
        to_global.append(to_global[-1][bb.vstar])
    return Hierarchy(levels=levels, to_global=to_global, backbones=backbones)


def _backbone_sets(g_i: CSRGraph, g_rev: CSRGraph, in_vstar: np.ndarray,
                   v: int, eps: int):
    """(B_out, B_in) per Formulas 1/2: backbone vertices within eps of v,
    pruned when another candidate lies between (d(v,x)<=eps ^ d(x,u)<=eps).
    ``g_rev`` is the caller-hoisted reverse of ``g_i`` (this runs per
    vertex; rebuilding the reverse CSR each call dominated the level)."""
    cand_out = [u for u in _khop_out(g_i, v, eps) if in_vstar[u]]
    pruned_out: List[int] = []
    if cand_out:
        reach2 = {x: _khop_out(g_i, x, eps) for x in cand_out}
        for u in cand_out:
            if not any(x != u and u in reach2[x] for x in cand_out):
                pruned_out.append(u)

    cand_in = [u for u in _khop_out(g_rev, v, eps) if in_vstar[u]]
    pruned_in: List[int] = []
    if cand_in:
        reach2r = {x: _khop_out(g_rev, x, eps) for x in cand_in}
        for u in cand_in:
            # exists y with d(u,y)<=eps and d(y,v)<=eps  <=>  reverse: y reaches u
            if not any(x != u and u in reach2r[x] for x in cand_in):
                pruned_in.append(u)
    return pruned_out, pruned_in


def core_labels_formula3(core: CSRGraph, eps: int = 2):
    """Formula 3 (valid when diameter(core) <= eps): L = ceil(eps/2)-neighborhood."""
    k = (eps + 1) // 2
    rev = core.reverse()
    out_lists = [sorted({v} | _khop_out(core, v, k)) for v in range(core.n)]
    in_lists = [sorted({v} | _khop_out(rev, v, k)) for v in range(core.n)]
    return out_lists, in_lists


def hierarchical_labeling(
    g: CSRGraph,
    eps: int = 2,
    core_max: int = 1024,
    max_levels: int = 10,
    core_method: str = "distribution",
    device="cuda",
) -> ReachabilityOracle:
    t0 = time.perf_counter()
    hier = decompose(g, eps=eps, core_max=core_max, max_levels=max_levels)
    t_decompose = time.perf_counter()
    h = hier.h
    n = g.n

    empty = np.empty(0, dtype=np.int32)
    out_rows: List[np.ndarray] = [empty] * n  # sorted unique global hop ids
    in_rows: List[np.ndarray] = [empty] * n

    # ---- core labeling (global hop ids) ----
    core = hier.levels[h]
    core_glob = hier.to_global[h].astype(np.int32)
    if core_method == "formula3":
        c_out, c_in = core_labels_formula3(core, eps)
        for lv in range(core.n):
            gv = int(core_glob[lv])
            out_rows[gv] = np.sort(core_glob[np.asarray(c_out[lv], dtype=np.int64)])
            in_rows[gv] = np.sort(core_glob[np.asarray(c_in[lv], dtype=np.int64)])
    else:
        core_oracle = distribution_labeling(core, device=device)
        for lv in range(core.n):
            gv = int(core_glob[lv])
            # DL labels live in rank space; map back to core-local vertex ids
            # before lifting to global ids
            row_o = core_oracle.unrank(core_oracle.L_out[lv, : core_oracle.out_len[lv]])
            row_i = core_oracle.unrank(core_oracle.L_in[lv, : core_oracle.in_len[lv]])
            out_rows[gv] = np.sort(core_glob[row_o])
            in_rows[gv] = np.sort(core_glob[row_i])

    t_core = time.perf_counter()

    # ---- level-wise labeling h-1 .. 0 (Formulas 4/5) ----
    # All vertices of a level are independent (labels inherit only from
    # higher-level backbone rows and plain neighbor IDS), so each side of a
    # level is ONE batched union over (vertex, hop) pairs — the gathers run
    # through the wave sweeps' csr_gather, the union through
    # ``traverse.batched_union_rows``; no per-vertex python set work.
    for i in range(h - 1, -1, -1):
        g_i = hier.levels[i]
        glob_i = hier.to_global[i].astype(np.int32)
        bb = hier.backbones[i]
        in_vstar = np.zeros(g_i.n, dtype=bool)
        in_vstar[bb.vstar] = True
        g_i_rev = g_i.reverse()
        lvs = np.flatnonzero(~in_vstar).astype(np.int64)
        if lvs.size == 0:
            continue
        b_out_all, b_in_all = zip(*(_backbone_sets(g_i, g_i_rev, in_vstar,
                                                   int(lv), eps) for lv in lvs))
        for rows, g_dir, b_all in (
            (out_rows, g_i, b_out_all),
            (in_rows, g_i_rev, b_in_all),
        ):
            nbrs, seg = bitset.csr_gather(
                g_dir.indptr.astype(np.int64), g_dir.indices.astype(np.int64), lvs
            )
            keys = [np.arange(lvs.size, dtype=np.int64), seg]
            vals = [glob_i[lvs], glob_i[nbrs]]  # {v} u N1(v|G_i)
            for k, b_locals in enumerate(b_all):  # u U_{u in B(v)} L(u)
                for u in b_locals:
                    row = rows[int(glob_i[u])]
                    keys.append(np.full(row.shape[0], k, dtype=np.int64))
                    vals.append(row)
            level_rows = batched_union_rows(
                np.concatenate(keys), np.concatenate(vals), lvs.size, n
            )
            for k, lv in enumerate(lvs):
                rows[int(glob_i[lv])] = level_rows[k]

    oracle = finalize_labels(out_rows, in_rows)
    t_end = time.perf_counter()
    object.__setattr__(oracle, "build_stats", {
        "impl": "hierarchical",
        "level_sizes": [lv.n for lv in hier.levels],
        "stages": {"decompose": t_decompose - t0, "core": t_core - t_decompose,
                   "levelwise": t_end - t_core},
    })
    return oracle
