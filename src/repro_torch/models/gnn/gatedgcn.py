"""GatedGCN (Bresson & Laurent; benchmarking config of arXiv:2003.00982), the
port of ``repro.models.gnn.gatedgcn``'s ``forward`` and ``loss_fn``.

Per layer, with explicit edge features:
  e'_ij = A h_i + B h_j + C e_ij;      eta_ij = sigmoid(e'_ij)
  h'_i  = h_i U + ( sum_j eta_ij * (h_j V) ) / ( sum_j eta_ij + eps )
residual + LayerNorm on both node and edge streams.
Assigned config: 16 layers, d_hidden=70, gated aggregator.

The messages are per-feature vectors (eta is [m, d]), not one weight an
edge, so the aggregation is torch's ``index_add_`` (``segment_agg``), not K5.
Over a mesh's data group, one process a rank: ``make_sharded_loss`` is
``loss_fn`` over a graph split in JAX's layout (node blocks, edge blocks
whatever their ends), ``make_dstlocal_loss`` the JAX package's dst-local
variant; both exchange through ``repro_torch.dist.sharded``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist import sharded
from repro_torch.launch.mesh import ONE_RANK, AxisGroup, axis_group
from repro_torch.models.gnn.layers import GraphBatch, masked_nll, segment_agg
from repro_torch.models.jax_params import tree_from_jax


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_in: int = 16
    d_edge_in: int = 8
    d_hidden: int = 70
    n_classes: int = 8
    dtype: torch.dtype = torch.float32


def init_params(cfg: GatedGCNConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights with JAX's tree, shapes and scales, drawn from
    ``generator`` (its numbers are not ``jax.random``'s)."""
    dev = resolve_device(device)
    d = cfg.d_hidden

    def lin(i, o):
        return torch.randn((i, o), generator=generator, device=dev).div_(np.sqrt(i)).to(cfg.dtype)

    params = {"embed_x": lin(cfg.d_in, d), "embed_e": lin(cfg.d_edge_in, d),
              "readout": lin(d, cfg.n_classes), "layers": []}
    for _ in range(cfg.n_layers):
        layer = {name: lin(d, d) for name in "ABCUV"}
        layer["ln_h"] = torch.ones((d,), dtype=cfg.dtype, device=dev)
        layer["ln_e"] = torch.ones((d,), dtype=cfg.dtype, device=dev)
        params["layers"].append(layer)
    return params


def params_from_jax(cfg: GatedGCNConfig, params, device="cuda") -> dict:
    return tree_from_jax(params, resolve_device(device))


def _norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * w


def _layer(lw, h: torch.Tensor, h_all: torch.Tensor, e: torch.Tensor, src: torch.Tensor,
           dst: torch.Tensor, aggregate):
    """One layer over a rank's edges (global ids ``src``, ``dst``): ``h``
    its node rows, ``h_all`` the whole node stream, ``e`` its edges' state;
    ``aggregate(messages, eta)`` sums both into (num, den) at h's rows.
    Returns the new (h, e)."""
    h_src, h_dst = h_all[src], h_all[dst]
    e_new = h_dst @ lw["A"] + h_src @ lw["B"] + e @ lw["C"]
    eta = torch.sigmoid(e_new)
    num, den = aggregate(eta * (h_src @ lw["V"]), eta)
    h = h + F.relu(_norm(h @ lw["U"] + num / (den + 1e-6), lw["ln_h"]))
    return h, e + F.relu(_norm(e_new, lw["ln_e"]))


def _edge_state(cfg: GatedGCNConfig, params, edge_attr, m: int, device) -> torch.Tensor:
    e_attr = edge_attr if edge_attr is not None else torch.zeros(
        (m, cfg.d_edge_in), dtype=cfg.dtype, device=device)
    return e_attr.to(cfg.dtype) @ params["embed_e"]


def _logits(cfg: GatedGCNConfig, params, g: GraphBatch, ag: AxisGroup) -> torch.Tensor:
    """This rank's [n/P, n_classes] logits, ``g`` its node rows and its
    block of edges with global ids (JAX's layout); each layer gathers the
    node stream (``dist.sharded.gather``, in the model's dtype), sums the
    rank's messages and gates into an n-wide partial in the model's dtype
    and reduce-scatters both at once onto their owners' rows.  The edge
    state stays with its edges.  One rank: ``forward``."""
    n = g.x.shape[0] * ag.size
    d = cfg.d_hidden
    src, dst = g.edge_src.long(), g.edge_dst.long()
    h = g.x.to(cfg.dtype) @ params["embed_x"]
    e = _edge_state(cfg, params, g.edge_attr, src.shape[0], h.device)

    def aggregate(messages, eta):
        both = segment_agg(torch.cat([messages, eta], dim=-1), g.edge_dst, g.edge_mask, n, "sum")
        return sharded.scatter_sum(both, ag).split(d, dim=-1)

    for lw in params["layers"]:
        h, e = _layer(lw, h, sharded.gather(h, ag), e, src, dst, aggregate)
    return h @ params["readout"]


def forward(cfg: GatedGCNConfig, params, g: GraphBatch) -> torch.Tensor:
    """[n, n_classes] logits."""
    return _logits(cfg, params, g, ONE_RANK)


def loss_fn(cfg: GatedGCNConfig, params, g: GraphBatch) -> torch.Tensor:
    return masked_nll(forward(cfg, params, g), g.y, g.node_mask)


def make_sharded_loss(cfg: GatedGCNConfig, mesh, data_axes: Sequence[str] = ("data",)):
    """JAX's ``loss_fn`` as one rank's program over a graph split over
    ``mesh``'s ``data_axes`` (``None``: one rank) in JAX's layout, the
    baseline beside the dst-local variant: ``g`` holds this rank's node
    block (x, node_mask, y: n/P rows) and its block of m/P edges (global
    ids, edge_attr, edge_mask), whatever their ends (``_logits``).  The
    loss is ``loss_fn``'s, the same on every rank, and
    ``torch.autograd.grad`` of it gives each rank the whole gradient of the
    params (``dist.sharded.Replicated``).  Collective: every rank calls it,
    forward and backward."""
    ag = ONE_RANK if mesh is None else axis_group(mesh, data_axes)

    def loss(params, g: GraphBatch) -> torch.Tensor:
        params = sharded.replicated(params, ag)
        return masked_nll(_logits(cfg, params, g, ag), g.y, g.node_mask, ag)

    return loss


# ---------------------------------------------------------------------------
# dst-local distributed loss
#
# With the dst-local edge layout (graph/partition.py) each rank aggregates
# only its own n/P destination rows; the one exchange a layer is an
# all-gather of the node stream in bfloat16, whose adjoint in the backward
# is a reduce-scatter of its gradient.
# ---------------------------------------------------------------------------

def _gather_nodes(h: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """The layer's exchange: every rank's node rows h [n/P, d] -> the whole
    stream [n, d], gathered in bfloat16 and returned in h's dtype; backward
    the stream's gradient summed over the ranks in float32
    (``dist.sharded.Gather``).  Looked up at each call, so that a check can
    put a wrong exchange in its place."""
    return sharded.gather(h, ag, torch.bfloat16)


def make_dstlocal_loss(cfg: GatedGCNConfig, mesh, data_axes: Sequence[str] = ("data",),
                       local: bool = False):
    """JAX's ``make_dstlocal_loss``: ``loss(params, g)`` over a GraphBatch
    ``g`` in the dst-local layout (``graph.partition.partition_edges_by_dst``:
    edge block p holds the edges into vertex block p), the whole batch on
    every rank.  Each rank of ``mesh``'s ``data_axes`` (``("data",)`` or
    ``("pod", "data")``) takes its n/P node rows and its edge block, gathers
    the node stream in bfloat16 each layer (``_gather_nodes``) and sums its
    messages into its own rows (``index_add_``).  The loss, a global sum
    over a global count, is the same on every rank, and
    ``torch.autograd.grad`` of it gives each rank the whole gradient of the
    params.  With ``local`` each rank is given only its own node block and
    edge block (as a dry-run cell places the graph).  Collective: every rank
    calls it, forward and backward."""
    ag = axis_group(mesh, data_axes)

    def loss(params, g: GraphBatch) -> torch.Tensor:
        params = sharded.replicated(params, ag)
        parts = 1 if local else ag.size
        n_local = g.x.shape[0] // parts
        m_local = g.edge_src.shape[0] // parts
        offset = ag.index * n_local
        first_row, first_edge = (0, 0) if local else (offset, ag.index * m_local)
        rows = slice(first_row, first_row + n_local)
        edges = slice(first_edge, first_edge + m_local)
        src, dst = g.edge_src[edges].long(), g.edge_dst[edges].long()
        emask, nmask, y = g.edge_mask[edges], g.node_mask[rows], g.y[rows]
        dst_local = (dst - offset).clamp(0, n_local - 1)
        h = g.x[rows].to(cfg.dtype) @ params["embed_x"]
        e = _edge_state(cfg, params, g.edge_attr[edges] if g.edge_attr is not None else None,
                        m_local, g.x.device)

        def aggregate(messages, eta):
            return (segment_agg(messages, dst_local, emask, n_local, "sum"),
                    segment_agg(eta, dst_local, emask, n_local, "sum"))

        for lw in params["layers"]:
            h, e = _layer(lw, h, _gather_nodes(h, ag), e, src, dst, aggregate)
        return masked_nll(h @ params["readout"], y, nmask, ag)

    return loss
