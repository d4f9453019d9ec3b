"""Input generators: a deployment's graph and the §5.2 order, made on the
run's device from a seed, in a few large calls.

The graph families follow the port's ``repro_torch.graph.generators``
(``random_dag`` for the paper's sparse graphs, ``tree_dag`` for its
ontology trees), copied here in torch so that the yardstick does not move
when the program does.
"""
from __future__ import annotations

import torch

INVALID = -1


def random_dag(gen: torch.Generator, n: int, m: int, device) -> tuple:
    """int32 edges (src, dst) of a uniform random DAG: ``m`` pairs of
    distinct uniform vertices, each edge pointing from the lower to the
    higher of the two ranks a random permutation gives them (duplicates
    kept, as an edge list may hold them)."""
    rank = torch.randperm(n, generator=gen, device=device)
    k = int(m * 1.3) + 16
    a = torch.randint(0, n, (k,), generator=gen, device=device)
    b = torch.randint(0, n, (k,), generator=gen, device=device)
    keep = a != b
    a, b = a[keep][:m], b[keep][:m]
    if a.shape[0] < m:
        raise ValueError(f"drew {a.shape[0]} distinct pairs of {m}")
    up = rank[a] < rank[b]
    return torch.where(up, a, b).to(torch.int32), torch.where(up, b, a).to(torch.int32)


def tree_dag(gen: torch.Generator, n: int, m: int, branching: int, device) -> tuple:
    """int32 edges (src, dst) of an ontology-style DAG: the tree in which
    vertex i > 0 hangs under (i - 1) // ``branching`` (root 0), its edges
    parent to child, and ``m - (n - 1)`` cross edges between distinct
    uniform vertices, lower id to higher."""
    child = torch.arange(1, n, device=device)
    src, dst = [torch.div(child - 1, branching, rounding_mode="floor")], [child]
    extra = m - (n - 1)
    if extra < 0:
        raise ValueError(f"a tree of {n} vertices has {n - 1} edges, more than m = {m}")
    if extra:
        k = int(extra * 1.3) + 16
        a = torch.randint(0, n, (k,), generator=gen, device=device)
        b = torch.randint(0, n, (k,), generator=gen, device=device)
        keep = a != b
        a, b = a[keep][:extra], b[keep][:extra]
        src.append(torch.minimum(a, b))
        dst.append(torch.maximum(a, b))
    return torch.cat(src).to(torch.int32), torch.cat(dst).to(torch.int32)


def degree_product_order(src: torch.Tensor, dst: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """int64[k]: the first ``k`` vertices of the paper's §5.2 order,
    (out-degree + 1) x (in-degree + 1) descending, ties by id."""
    score = (torch.bincount(src, minlength=n) + 1) * (torch.bincount(dst, minlength=n) + 1)
    return torch.argsort(-score, stable=True)[:k]


def structure(config: dict, device) -> tuple:
    """The configuration's graph, (src, dst) int32, drawn from its
    ``structure_seed`` in its ``family`` (``sparse`` or ``tree``)."""
    g = torch.Generator(device=device).manual_seed(config["structure_seed"])
    n, m = config["n"], config["m"]
    if config["family"] == "sparse":
        return random_dag(g, n, m, device)
    if config["family"] == "tree":
        return tree_dag(g, n, m, config["branching"], device)
    raise ValueError(f"unknown graph family {config['family']!r}")


def relabeled_graph(config: dict, seed: int, k: int, device) -> tuple:
    """The deployment's graph under the numbering ``seed`` draws.

    The structure (edges and the order's first ``k`` vertices) is the
    configuration's: the graph a deployment holds.  ``seed`` draws a
    permutation of the vertex ids, so every seed gives other inputs and the
    same work: the same cones, BFS depths and pruning.  Returns int32
    (src, dst) and int64[k] order."""
    n = config["n"]
    src, dst = structure(config, device)
    order = degree_product_order(src, dst, n, k)
    perm = torch.randperm(n, generator=torch.Generator(device=device).manual_seed(seed),
                          device=device).to(torch.int32)
    return perm[src.long()], perm[dst.long()], perm[order].long()
