"""The GNN family's shared substrate, the port of ``repro.models.gnn.layers``:
the ``GraphBatch`` container and masked segment message passing.

Message passing is an edge-indexed gather and a segment reduce to the
destination nodes, with static shapes (padded edge lists and a bool mask).
``segment_agg`` reduces with torch's ``index_add_`` (sum, mean) and
``scatter_reduce_`` (max), where the JAX package takes ``jax.ops.segment_*``.

GCN's aggregation, a weighted sum of source rows, is K5's function: its
``ell_from_edges`` lays a graph's valid in-edges out as the ELL rows that
``repro_torch.kernels.ops.ell_spmm`` takes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class GraphBatch(NamedTuple):
    """Static-shape batched graph.

    x:         f32[n, f]      node features
    edge_src:  int32[m]       source node index per edge (padding -> 0)
    edge_dst:  int32[m]       destination node index per edge
    edge_mask: bool[m]
    node_mask: bool[n]
    edge_attr: f32[m, fe] | None
    pos:       f32[n, 3] | None    (SchNet)
    y:         f32/int32[...]      targets (model-specific)
    """

    x: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_mask: torch.Tensor
    node_mask: torch.Tensor
    edge_attr: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    y: Optional[torch.Tensor] = None


def segment_sum(messages: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``out[i] = sum of messages[e] over e with seg[e] == i``: [n, *rest] in
    messages' dtype.  bfloat16 and float16 messages are summed in float32
    and the sums rounded once: summed in their own type, each add would
    round, in the order the card's atomics land, which varies from run to
    run (graphcast in bfloat16 moved by 0.39-0.59 of its float32 re-run's
    rms so)."""
    acc = messages.float() if messages.dtype in (torch.bfloat16, torch.float16) else messages
    out = acc.new_zeros((n, *messages.shape[1:]))
    return out.index_add_(0, seg.long(), acc).to(messages.dtype)


def segment_agg(messages: torch.Tensor, edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                n: int, agg: str = "sum") -> torch.Tensor:
    """Masked scatter-aggregate of messages [m, f] to their destination
    nodes: sum, mean (over the valid in-edges, at least 1) or max (0 where a
    node has none)."""
    mask = edge_mask[:, None]
    if agg == "sum":
        return segment_sum(torch.where(mask, messages, 0.0), edge_dst, n)
    if agg == "mean":
        s = segment_sum(torch.where(mask, messages, 0.0), edge_dst, n)
        cnt = segment_sum(edge_mask.to(messages.dtype), edge_dst, n)
        return s / cnt.clamp_min(1.0)[:, None]
    if agg == "max":
        neg = torch.where(mask, messages, -torch.inf)
        out = messages.new_full((n, messages.shape[1]), -torch.inf)
        out.scatter_reduce_(0, edge_dst.long()[:, None].expand_as(neg), neg, "amax")
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(agg)


def gcn_sym_coeff(edge_src: torch.Tensor, edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Symmetric GCN normalization 1/sqrt((deg(src)+1)(deg(dst)+1)) per edge,
    the degrees counting valid edges."""
    ones = edge_mask.to(torch.float32)
    deg_out = segment_sum(ones, edge_src, n)
    deg_in = segment_sum(ones, edge_dst, n)
    return torch.rsqrt((deg_out[edge_src.long()] + 1.0) * (deg_in[edge_dst.long()] + 1.0))


def ell_from_edges(edge_src: torch.Tensor, edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                   coeff: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The valid edges as ELL rows by destination, K5's layout: ``nbr``
    int32[n, w] (the sources of node i's in-edges in edge order, a stable
    sort by destination, then -1) and ``wgt`` float32[n, w] (their
    ``coeff``, then 0); w is the largest valid in-degree, at least 1.  So
    ``ops.ell_spmm(nbr, wgt, h)[i] = sum over i's valid in-edges e of
    coeff[e] * h[src[e]]``, ``segment_agg(h[src] * coeff, dst, mask, n)``.
    Built once a graph; one host read (w)."""
    valid = edge_mask.nonzero().flatten()
    dst = edge_dst[valid].long()
    dst, order = torch.sort(dst, stable=True)
    e = valid[order]
    counts = torch.bincount(dst, minlength=n)
    w = max(1, int(counts.max())) if dst.numel() else 1
    slot = torch.arange(dst.numel(), device=dst.device) - (torch.cumsum(counts, 0) - counts)[dst]
    nbr = torch.full((n, w), -1, dtype=torch.int32, device=dst.device)
    wgt = torch.zeros((n, w), dtype=torch.float32, device=dst.device)
    nbr[dst, slot] = edge_src[e].to(torch.int32)
    wgt[dst, slot] = coeff[e].to(torch.float32)
    return nbr, wgt


def mlp_init(gen: torch.Generator, sizes, dtype=torch.float32, device="cpu") -> list:
    """JAX's ``mlp_init``: a layer's weight normal / sqrt(fan_in), its bias 0;
    drawn from the torch generator ``gen`` (not ``jax.random``'s numbers)."""
    return [{"w": torch.randn((i, o), generator=gen, device=device).div_(np.sqrt(i)).to(dtype),
             "b": torch.zeros((o,), dtype=dtype, device=device)}
            for i, o in zip(sizes[:-1], sizes[1:])]


def mlp_apply(params: list, x: torch.Tensor, act=F.relu, final_act: bool = False) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x
