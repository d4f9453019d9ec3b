"""Fanout neighbor sampler for sampled GNN training (minibatch_lg shape), the
port of ``repro.graph.sampler`` (numpy, the same draws from the same
generator).

GraphSAGE-style layered sampling: for a seed batch, sample up to fanout[0]
in-neighbors, then fanout[1] of theirs, etc. Produces a fixed-shape padded
block (device-friendly: every batch has the same shapes).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from repro_torch.graph.csr import INVALID, CSRGraph


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One sampled computation block (fixed shapes for a given (batch, fanouts)).

    nodes:    int32[n_total]    global ids, INVALID padding; seeds first
    edge_src: int32[n_edges]    local indices into `nodes`
    edge_dst: int32[n_edges]    local indices into `nodes`
    edge_mask: bool[n_edges]
    n_seeds:  int
    """

    nodes: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    n_seeds: int


def sample_block(g_rev: CSRGraph, seeds: np.ndarray, fanouts: Sequence[int],
                 rng: np.random.Generator) -> SampledBlock:
    """Sample a block from the *reverse* CSR (message flow dst<-src).

    Shapes depend only on (len(seeds), fanouts): n_total = B*(1+f0+f0*f1+...),
    n_edges = B*f0 + B*f0*f1 + ...
    """
    B = seeds.shape[0]
    layer_nodes = [np.asarray(seeds, dtype=np.int32)]
    all_src, all_dst, all_mask = [], [], []
    offset = 0  # local index offset of the current dst layer
    for f in fanouts:
        dst_nodes = layer_nodes[-1]
        k = dst_nodes.shape[0]
        src_nodes = np.full(k * f, INVALID, dtype=np.int32)
        mask = np.zeros(k * f, dtype=bool)
        for i, v in enumerate(dst_nodes):
            if v == INVALID:
                continue
            nbrs = g_rev.out_neighbors(int(v))  # in-neighbors of v in the original graph
            if nbrs.shape[0] == 0:
                continue
            take = min(f, nbrs.shape[0])
            choice = rng.choice(nbrs, size=take, replace=nbrs.shape[0] < take)
            src_nodes[i * f: i * f + take] = choice
            mask[i * f: i * f + take] = True
        all_src.append(np.arange(k * f, dtype=np.int32) + offset + k)
        all_dst.append(np.repeat(np.arange(k, dtype=np.int32) + offset, f))
        all_mask.append(mask)
        layer_nodes.append(src_nodes)
        offset += k
    return SampledBlock(
        nodes=np.concatenate(layer_nodes),
        edge_src=np.concatenate(all_src),
        edge_dst=np.concatenate(all_dst),
        edge_mask=np.concatenate(all_mask),
        n_seeds=B,
    )


def block_shapes(batch: int, fanouts: Sequence[int]) -> Tuple[int, int]:
    """(n_total_nodes, n_edges) for given batch/fanouts -- static per config."""
    n_total, n_edges, k = batch, 0, batch
    for f in fanouts:
        n_edges += k * f
        k = k * f
        n_total += k
    return n_total, n_edges
