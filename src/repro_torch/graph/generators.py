"""Synthetic DAG generators matched to the paper's benchmark dataset profiles.

The 2013 paper evaluates on 12 small graphs (biological/XML, n ~ 1k-40k,
m ~= n, sparse & shallow) and 9 large graphs (citation/protein, n up to 25M).
Those exact files are not redistributable here, so each named dataset maps to
a generator with matched (n, m) and a structural family:

  * ``*cyc`` / kegg / reactome etc.  -> sparse near-tree DAGs (m ~= 1.05 n)
  * citeseer / citeseerx / cit-Patents -> citation-style layered DAGs
  * go_uniprot / uniprotenc_*        -> wide shallow ontology trees
  * mapped_*                         -> sparse random DAGs

All generators return a condensed DAG (they generate DAGs directly).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.graph.csr import CSRGraph, from_edges


def random_dag(n: int, m: int, seed: int = 0) -> CSRGraph:
    """Uniform random DAG: m edges oriented low->high under a random permutation."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int64)
    # sample pairs, orient by permutation rank
    k = int(m * 1.3) + 16
    a = rng.integers(0, n, size=k)
    b = rng.integers(0, n, size=k)
    mask = a != b
    a, b = a[mask], b[mask]
    ra, rb = perm[a], perm[b]
    src = np.where(ra < rb, a, b)
    dst = np.where(ra < rb, b, a)
    return from_edges(n, src[:m], dst[:m])


def layered_dag(
    n: int, avg_out: float = 2.0, n_layers: int = 12, skip: float = 0.15, seed: int = 0
) -> CSRGraph:
    """Citation-style DAG: vertices in layers, edges point to earlier layers,
    with a `skip` fraction jumping >1 layer (long-range citations)."""
    rng = np.random.default_rng(seed)
    layer = rng.integers(0, n_layers, size=n)
    order = np.argsort(layer, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    m = int(n * avg_out)
    src = rng.integers(0, n, size=m)
    # destination: a vertex with strictly smaller rank (earlier layer region)
    lo = np.maximum(rank[src] * (1.0 - np.where(rng.random(m) < skip, 0.9, 0.3)), 0)
    dst_rank = (lo + rng.random(m) * np.maximum(rank[src] - lo, 1)).astype(np.int64)
    dst_rank = np.minimum(dst_rank, np.maximum(rank[src] - 1, 0))
    dst = order[dst_rank]
    keep = rank[src] > rank[dst]
    return from_edges(n, src[keep], dst[keep])


def tree_dag(n: int, branching: int = 8, extra_frac: float = 0.05, seed: int = 0) -> CSRGraph:
    """Ontology-style: a shallow tree (root -> leaves) + a few cross edges.

    Matches go_uniprot / uniprotenc profiles (m ~= n - 1).
    """
    rng = np.random.default_rng(seed)
    parent = np.maximum((np.arange(1, n) - 1) // branching, 0)
    src = [parent, ]
    dst = [np.arange(1, n), ]
    n_extra = int(n * extra_frac)
    if n_extra:
        a = rng.integers(0, n, size=n_extra)
        b = rng.integers(0, n, size=n_extra)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        keep = lo != hi
        src.append(lo[keep])
        dst.append(hi[keep])
    return from_edges(n, np.concatenate(src), np.concatenate(dst))


def scale_free_dag(n: int, avg_out: float = 4.0, seed: int = 0) -> CSRGraph:
    """Preferential-attachment DAG (new vertex links to earlier, degree-biased)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_out)
    # Efficient PA approximation: sample targets from the edge-endpoint pool.
    src = np.empty(m, dtype=np.int64)
    dst = np.empty(m, dtype=np.int64)
    pool = np.zeros(m, dtype=np.int64)  # endpoint pool for preferential choice
    pool_size = 0
    e = 0
    for v in range(1, n):
        k = int(np.clip(rng.poisson(avg_out), 1, v))
        k = min(k, m - e)
        for _ in range(k):
            if pool_size > 0 and rng.random() < 0.7:
                t = pool[rng.integers(0, pool_size)]
            else:
                t = rng.integers(0, v)
            src[e] = v
            dst[e] = t
            if pool_size < m:
                pool[pool_size] = t
                pool_size += 1
            e += 1
        if e >= m:
            break
    return from_edges(n, src[:e], dst[:e])


def chain_dag(n: int, width: int = 4, seed: int = 0) -> CSRGraph:
    """Deep narrow DAG (worst-ish case for hop labeling depth)."""
    rng = np.random.default_rng(seed)
    layers = n // width
    src, dst = [], []
    for l in range(layers - 1):
        a = np.arange(l * width, (l + 1) * width)
        for _ in range(2):
            b = l * width + width + rng.integers(0, width, size=width)
            src.append(a)
            dst.append(np.minimum(b, n - 1))
    return from_edges(n, np.concatenate(src), np.concatenate(dst))


# ---------------------------------------------------------------------------
# Paper dataset registry: name -> (n, m, family). n/m from Table 1.
# "small" graphs are generated at full scale; "large" at full scale for DL
# benchmarking (construction is O(n+m)-ish) but capped via --scale for CI.
# ---------------------------------------------------------------------------
PAPER_DATASETS: Dict[str, dict] = {
    # small (Table 1 left)
    "agrocyc": dict(n=12684, m=13408, family="sparse"),
    "amaze": dict(n=3710, m=3600, family="sparse"),
    "anthra": dict(n=12499, m=13104, family="sparse"),
    "ecoo": dict(n=12620, m=13350, family="sparse"),
    "hpycyc": dict(n=4771, m=5859, family="sparse"),
    "human": dict(n=38811, m=39576, family="sparse"),
    "kegg": dict(n=3617, m=3908, family="sparse"),
    "mtbrv": dict(n=9602, m=10245, family="sparse"),
    "nasa": dict(n=5605, m=7735, family="layered"),
    "reactome": dict(n=901, m=846, family="sparse"),
    "vchocyc": dict(n=9491, m=10143, family="sparse"),
    "xmark": dict(n=6080, m=7028, family="tree"),
    # large (Table 1 right)
    "citeseer": dict(n=693947, m=312282, family="layered"),
    "go_uniprot": dict(n=6967956, m=34770235, family="tree"),
    "mapped_100K": dict(n=2658702, m=2660628, family="sparse"),
    "mapped_1M": dict(n=9387448, m=9440404, family="sparse"),
    "uniprotenc_22m": dict(n=1595443, m=1595442, family="tree"),
    "uniprotenc_100m": dict(n=16087294, m=16087293, family="tree"),
    "uniprotenc_150m": dict(n=25037599, m=25037598, family="tree"),
    "citeseerx": dict(n=6540399, m=15011259, family="layered"),
    "cit-Patents": dict(n=3774768, m=16518947, family="layered"),
}


def paper_dataset_analogue(name: str, scale: float = 1.0, seed: int = 7) -> CSRGraph:
    """Generate the synthetic analogue of a paper dataset, optionally scaled down."""
    spec = PAPER_DATASETS[name]
    n = max(int(spec["n"] * scale), 64)
    m = max(int(spec["m"] * scale), n // 2)
    fam = spec["family"]
    if fam == "sparse":
        return random_dag(n, m, seed=seed)
    if fam == "layered":
        return layered_dag(n, avg_out=max(m / n, 0.5), seed=seed)
    if fam == "tree":
        branching = max(int(round(n / max(m - n, 1))) if m > n else 8, 2)
        return tree_dag(n, branching=min(branching, 64), extra_frac=max(m / n - 1.0, 0.02), seed=seed)
    raise ValueError(fam)
