"""Pre-intersection short-circuits (O'Reach-style cheap observations).

Hanauer et al. (2020) show that most reachability queries on real graphs can
be decided by O(1) pre-filters before any label work; the intersection then
only runs on the residue. Four filters, all vectorized on the host (numpy;
written against the common array API, so torch tensors work as well):

  * u == v                      -> True  (reflexive; same condensation vertex
                                          also covers same-SCC original pairs.
                                          The engine maps original ids through
                                          its owner's comp_source at CALL time
                                          — never a comp array cached at
                                          engine construction — so dynamic
                                          SCC merges can't serve stale
                                          same-SCC verdicts)
  * out_len[u] == 0             -> False (u reaches nothing but itself)
  * in_len[v] == 0              -> False (nothing but v reaches v)
  * level[u] >= level[v]        -> False (topological-level filter: every
                                          edge strictly increases the level,
                                          so reachability implies
                                          level[u] < level[v])
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph, topo_levels as _topo_levels_np


def topo_levels(g: CSRGraph) -> np.ndarray:
    """int32[n] longest-path level of each DAG vertex (sources = 0).

    u -> v (u != v) implies level[u] < level[v]; the contrapositive is the
    serve-path filter.  Vectorized in ``graph.csr.topo_levels`` (the scalar
    python walk this used to do was a visible slice of every dynamic-oracle
    rebuild publish).
    """
    return _topo_levels_np(g)


@dataclasses.dataclass(frozen=True)
class PrefilterResult:
    decided: np.ndarray  # bool[B] — query answered without intersection
    value: np.ndarray    # bool[B] — the answer where decided


def apply_prefilters(queries, out_len, in_len, level=None) -> PrefilterResult:
    """Decide what can be decided before gathering label rows.

    queries: int[B, 2] in oracle (condensation) id space. ``out_len``/
    ``in_len``/``level`` are per-vertex int arrays; ``level`` is optional.
    Works on numpy and torch inputs alike.
    """
    u, v = queries[:, 0], queries[:, 1]
    same = u == v
    dead = (out_len[u] == 0) | (in_len[v] == 0)
    if level is not None:
        dead = dead | (level[u] >= level[v])
    # `same` wins over `dead` (level[u] >= level[v] always holds for u == v)
    return PrefilterResult(decided=same | dead, value=same)
