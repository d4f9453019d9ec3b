"""GCN (Kipf & Welling, arXiv:1609.02907), the port of
``repro.models.gnn.gcn`` -- gcn-cora config: 2L, d=16.

Each layer's aggregation, ``sum over i's valid in-edges e of coeff[e] *
h[src[e]]`` with the symmetric normalisation ``gcn_sym_coeff``, is one K5
launch (``repro_torch.kernels.ops.ell_spmm``, a hand-written CUDA kernel on
the card, its plain version on the CPU) over the graph's ELL rows
(``ell_from_edges``, built once a graph), where the JAX package gathers
and segment-sums: ``n_layers`` K5 launches a forward.  The forward and
``loss_fn`` are differentiable: each aggregation's backward is K5 over the
same graph's rows by source (``graph_ell``'s transposed pair), one launch,
so a GCN layer's input gradient is ``K5^T(dX) + dX``.

``make_sharded_loss`` is the loss of one rank of a graph split over a
mesh's data axes in JAX's layout (node rows in blocks, edges split evenly
whatever their ends): the node stream is all-gathered a layer, each rank
sums its edges' messages into an n-wide partial (``index_add_``: K5's ELL
rows are cut from a whole destination set, which a rank's edge block is
not), and the partials are reduce-scattered onto the owners' rows -- what
JAX's partitioner does with the same program.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import ONE_RANK, axis_group, gather_rows, scatter_sum_rows, sum_over
from repro_torch.models.gnn.layers import GraphBatch, ell_from_edges, gcn_sym_coeff, segment_sum
from repro_torch.models.jax_params import tree_from_jax


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    dtype: torch.dtype = torch.float32   # K5 takes float32


def init_params(cfg: GCNConfig, generator: torch.Generator, device="cuda") -> list:
    """Random weights with JAX's shapes and scales (normal / sqrt(fan_in)),
    drawn from ``generator`` (its numbers are not ``jax.random``'s)."""
    dev = resolve_device(device)
    sizes = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return [{"w": torch.randn((i, o), generator=generator, device=dev).div_(np.sqrt(i))
             .to(cfg.dtype)} for i, o in zip(sizes[:-1], sizes[1:])]


def params_from_jax(cfg: GCNConfig, params, device="cuda") -> list:
    """The JAX package's params (a list of ``{"w"}``, numpy leaves) as the
    port's on ``device``."""
    return tree_from_jax(params, resolve_device(device))


class GraphELL(NamedTuple):
    """A graph's aggregation as K5's rows: ``nbr``/``wgt`` by destination
    (the forward's) and ``nbr_t``/``wgt_t`` by source (its backward's)."""

    nbr: torch.Tensor
    wgt: torch.Tensor
    nbr_t: torch.Tensor
    wgt_t: torch.Tensor


def graph_ell(g: GraphBatch) -> GraphELL:
    """The ELL rows of ``g``'s aggregation: its valid in-edges by
    destination, weighted by ``gcn_sym_coeff``, and the same edges by source
    (``ell_from_edges`` with source and destination swapped; its width is
    the largest out-degree)."""
    n = g.x.shape[0]
    coeff = gcn_sym_coeff(g.edge_src, g.edge_dst, g.edge_mask, n)
    fwd = ell_from_edges(g.edge_src, g.edge_dst, g.edge_mask, coeff, n)
    return GraphELL(*fwd, *ell_from_edges(g.edge_dst, g.edge_src, g.edge_mask, coeff, n))


def forward(cfg: GCNConfig, params, g: GraphBatch,
            ell: Optional[GraphELL] = None) -> torch.Tensor:
    """[n, n_classes] logits.  ``ell`` is ``graph_ell(g)``, made here when
    not given (a caller running several forwards over one graph makes it
    once).  Each layer: h = x W, x = K5(h) + h (the self loop), relu but
    after the last."""
    ell = graph_ell(g) if ell is None else ell
    x = g.x.to(cfg.dtype)
    for i, layer in enumerate(params):
        h = x @ layer["w"]
        x = ops.ell_spmm(ell.nbr, ell.wgt, h, ell.nbr_t, ell.wgt_t) + h
        if i < len(params) - 1:
            x = F.relu(x)
    return x


def loss_fn(cfg: GCNConfig, params, g: GraphBatch, ell=None) -> torch.Tensor:
    """Node classification cross-entropy over ``g.node_mask``'s nodes."""
    logp = torch.log_softmax(forward(cfg, params, g, ell).float(), dim=-1)
    ll = logp.gather(1, g.y.long()[:, None])[:, 0]
    return -torch.where(g.node_mask, ll, 0.0).sum() / g.node_mask.sum().clamp_min(1)


class _Gather(torch.autograd.Function):
    """This rank's rows [n/P, F] -> the whole [n, F] (``gather_rows``);
    backward: the gradient summed over the ranks, each keeping its rows."""

    @staticmethod
    def forward(ctx, h, ag):
        ctx.ag = ag
        return gather_rows(h, ag) if ag.size > 1 else h

    @staticmethod
    def backward(ctx, grad):
        return (scatter_sum_rows(grad.contiguous(), ctx.ag) if ctx.ag.size > 1 else grad), None


class _ScatterSum(torch.autograd.Function):
    """An [n, F] partial summed over the ranks, each keeping its own rows
    (``scatter_sum_rows``); backward: the rows' gradients gathered."""

    @staticmethod
    def forward(ctx, partial, ag):
        ctx.ag = ag
        return scatter_sum_rows(partial.contiguous(), ag) if ag.size > 1 else partial

    @staticmethod
    def backward(ctx, grad):
        return (gather_rows(grad.contiguous(), ctx.ag) if ctx.ag.size > 1 else grad), None


def make_sharded_loss(cfg: GCNConfig, mesh, data_axes=("data",)):
    """``loss(params, g)`` of one rank of ``mesh``'s ``data_axes`` (``None``:
    one rank): ``g`` holds this rank's node block (x, node_mask, y: n/P
    rows) and its edge block (m/P edges, global ids).  The loss is
    ``loss_fn``'s, the same on every rank, and ``torch.autograd.grad`` of
    it gives each rank the whole gradient of the params (replicated: their
    gradients all-reduced).  The degrees count every rank's edges (one
    ``all_reduce`` each).  Collective: every rank calls it, forward and
    backward."""
    from repro_torch.models.gnn.gatedgcn import _Replicated, _SumOver
    from repro_torch.tree import tree_flatten, tree_unflatten

    ag = ONE_RANK if mesh is None else axis_group(mesh, data_axes)

    def loss(params, g: GraphBatch) -> torch.Tensor:
        leaves, treedef = tree_flatten(params)
        if ag.size > 1:
            params = tree_unflatten(treedef, list(_Replicated.apply(ag, *leaves)))
        n = g.x.shape[0] * ag.size
        src, dst = g.edge_src.long(), g.edge_dst.long()
        ones = g.edge_mask.to(torch.float32)
        deg_out = sum_over(segment_sum(ones, src, n), ag)
        deg_in = sum_over(segment_sum(ones, dst, n), ag)
        coeff = torch.rsqrt((deg_out[src] + 1.0) * (deg_in[dst] + 1.0))
        coeff = torch.where(g.edge_mask, coeff, 0.0)[:, None]
        x = g.x.to(cfg.dtype)
        for i, layer in enumerate(params):
            h = x @ layer["w"]
            partial = segment_sum(_Gather.apply(h, ag)[src] * coeff, dst, n)
            x = _ScatterSum.apply(partial, ag) + h
            if i < len(params) - 1:
                x = F.relu(x)
        logp = torch.log_softmax(x.float(), dim=-1)
        ll = logp.gather(1, g.y.long()[:, None])[:, 0]
        total = torch.where(g.node_mask, ll, 0.0).sum()
        if ag.size > 1:
            total = _SumOver.apply(total, ag)
        return -total / sum_over(g.node_mask.sum(), ag).clamp_min(1)

    return loss
