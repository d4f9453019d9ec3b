"""Vertex total orders (§5.2 'Vertex Order').

The paper's recommended rank function is (|N_out(v)|+1) * (|N_in(v)|+1) —
the number of vertex pairs within distance 2 covered by v. Higher rank =
earlier processing = more vertices record the hop.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def degree_product_rank(g: CSRGraph) -> np.ndarray:
    """Paper §5.2 rank: (dout+1)*(din+1), descending. Returns order int32[n]."""
    score = (g.out_degree().astype(np.int64) + 1) * (g.in_degree().astype(np.int64) + 1)
    # stable tiebreak on vertex id for reproducibility
    return np.argsort(-score, kind="stable").astype(np.int32)


def degree_sum_rank(g: CSRGraph) -> np.ndarray:
    score = g.out_degree().astype(np.int64) + g.in_degree().astype(np.int64)
    return np.argsort(-score, kind="stable").astype(np.int32)


def random_rank(g: CSRGraph, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).permutation(g.n).astype(np.int32)


ORDERS = {
    "degree_product": degree_product_rank,
    "degree_sum": degree_sum_rank,
    "random": random_rank,
}


def get_order(g: CSRGraph, name: str = "degree_product", **kw) -> np.ndarray:
    return ORDERS[name](g, **kw)
