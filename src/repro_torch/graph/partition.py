"""Vertex/edge partitioning for distributed message passing, the port of
``repro.graph.partition`` (numpy, its results byte for byte).

The dst-local contract: vertex blocks are contiguous ranges of n/P; edge
block p contains exactly the edges whose DESTINATION lies in vertex block p
(padded to equal size). Under this layout a segment-sum into destination
rows is shard-LOCAL: no dense n-sized partials, no all-reduce.
``repro_torch.models.gnn.gatedgcn.make_dstlocal_loss`` runs on it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph


def partition_edges_by_dst(
    g: CSRGraph, n_shards: int, n_pad: int | None = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Returns (src, dst, mask, edges_per_shard) with edges grouped by the
    destination's vertex block and each block padded to the max block size.

    n_pad: padded vertex count (blocks are n_pad / n_shards wide).
    """
    n = n_pad or g.n
    if n % n_shards:
        raise ValueError(f"{n} vertices do not split into {n_shards} blocks")
    block = n // n_shards
    src, dst = g.edges()
    owner = dst // block
    order = np.argsort(owner, kind="stable")
    src, dst, owner = src[order], dst[order], owner[order]
    counts = np.bincount(owner, minlength=n_shards)
    width = int(counts.max())
    out_src = np.zeros((n_shards, width), dtype=np.int32)
    out_dst = np.zeros((n_shards, width), dtype=np.int32)
    out_mask = np.zeros((n_shards, width), dtype=bool)
    start = 0
    for p in range(n_shards):
        c = int(counts[p])
        out_src[p, :c] = src[start : start + c]
        out_dst[p, :c] = dst[start : start + c]
        out_mask[p, :c] = True
        # padded entries point at the shard's own first vertex (masked anyway)
        out_dst[p, c:] = p * block
        start += c
    return (
        out_src.reshape(-1),
        out_dst.reshape(-1),
        out_mask.reshape(-1),
        width,
    )
