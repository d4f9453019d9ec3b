"""GatedGCN (Bresson & Laurent; benchmarking config of arXiv:2003.00982), the
port of ``repro.models.gnn.gatedgcn``'s ``forward`` and ``loss_fn``.

Per layer, with explicit edge features:
  e'_ij = A h_i + B h_j + C e_ij;      eta_ij = sigmoid(e'_ij)
  h'_i  = h_i U + ( sum_j eta_ij * (h_j V) ) / ( sum_j eta_ij + eps )
residual + LayerNorm on both node and edge streams.
Assigned config: 16 layers, d_hidden=70, gated aggregator.

The messages are per-feature vectors (eta is [m, d]), not one weight an
edge, so the aggregation is torch's ``index_add_`` (``segment_agg``), not K5.
``make_dstlocal_loss`` is the JAX package's dst-local distributed loss, one
process a rank over a mesh's data group.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import AxisGroup, axis_group, gather_rows, scatter_sum_rows, sum_over
from repro_torch.models.gnn.layers import GraphBatch, segment_agg
from repro_torch.models.jax_params import tree_from_jax
from repro_torch.tree import tree_flatten, tree_unflatten


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


def forward(cfg: GatedGCNConfig, params, g: GraphBatch) -> torch.Tensor:
    """[n, n_classes] logits."""
    n = g.x.shape[0]
    h = g.x.to(cfg.dtype) @ params["embed_x"]
    e_attr = g.edge_attr if g.edge_attr is not None else torch.zeros(
        (g.edge_src.shape[0], cfg.d_edge_in), dtype=cfg.dtype, device=h.device)
    e = e_attr.to(cfg.dtype) @ params["embed_e"]
    src, dst = g.edge_src.long(), g.edge_dst.long()
    for lw in params["layers"]:
        h_src, h_dst = h[src], h[dst]
        e_new = h_dst @ lw["A"] + h_src @ lw["B"] + e @ lw["C"]
        eta = torch.sigmoid(e_new)
        num = segment_agg(eta * (h_src @ lw["V"]), g.edge_dst, g.edge_mask, n, "sum")
        den = segment_agg(eta, g.edge_dst, g.edge_mask, n, "sum")
        h_new = h @ lw["U"] + num / (den + 1e-6)
        h = h + F.relu(_norm(h_new, lw["ln_h"]))
        e = e + F.relu(_norm(e_new, lw["ln_e"]))
    return h @ params["readout"]


def loss_fn(cfg: GatedGCNConfig, params, g: GraphBatch) -> torch.Tensor:
    logp = torch.log_softmax(forward(cfg, params, g).float(), dim=-1)
    ll = logp.gather(1, g.y.long()[:, None])[:, 0]
    return -torch.where(g.node_mask, ll, 0.0).sum() / g.node_mask.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# dst-local distributed loss
#
# With the dst-local edge layout (graph/partition.py) each rank aggregates
# only its own n/P destination rows; the one exchange a layer is an
# all-gather of the node stream in bfloat16, whose adjoint in the backward
# is a reduce-scatter of its gradient.
# ---------------------------------------------------------------------------

class _GatherNodes(torch.autograd.Function):
    """Every rank's node rows h [n/P, d] -> the whole stream [n, d]: gathered
    in bfloat16 (``gather_rows``, the group's order) and returned in h's
    dtype.  Backward: the stream's gradient summed over the ranks in
    float32, each rank keeping its own rows (``scatter_sum_rows``)."""

    @staticmethod
    def forward(ctx, h, ag):
        ctx.ag = ag
        return gather_rows(h.to(torch.bfloat16), ag).to(h.dtype)

    @staticmethod
    def backward(ctx, grad):
        return scatter_sum_rows(grad.float(), ctx.ag).to(grad.dtype), None


class _Replicated(torch.autograd.Function):
    """The params, held whole on every rank: the identity forward; backward,
    their gradients summed over the ranks in one ``all_reduce`` of them all
    flattened, so each rank gets the whole gradient of the global loss
    (JAX's adjoint of a replicated input)."""

    @staticmethod
    def forward(ctx, ag, *params):
        ctx.ag = ag
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        flat = sum_over(torch.cat([g.reshape(-1) for g in grads]), ctx.ag)
        return (None, *(x.view_as(g) for x, g in zip(flat.split([g.numel() for g in grads]),
                                                      grads)))


class _SumOver(torch.autograd.Function):
    """A scalar summed over the ranks (``all_reduce``); backward the
    identity: every rank holds the same loss, and its gradient reaches
    each rank's own terms once."""

    @staticmethod
    def forward(ctx, x, ag):
        return sum_over(x, ag)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _gather_nodes(h: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """The layer's exchange (``_GatherNodes``), looked up at each call, so
    that a check can put a wrong exchange in its place."""
    return _GatherNodes.apply(h, ag)


def make_dstlocal_loss(cfg: GatedGCNConfig, mesh, data_axes: Sequence[str] = ("data",)):
    """JAX's ``make_dstlocal_loss``: ``loss(params, g)`` over a GraphBatch
    ``g`` in the dst-local layout (``graph.partition.partition_edges_by_dst``:
    edge block p holds the edges into vertex block p), the whole batch on
    every rank.  Each rank of ``mesh``'s ``data_axes`` (``("data",)`` or
    ``("pod", "data")``) takes its n/P node rows and its edge block, gathers
    the node stream in bfloat16 each layer (``_GatherNodes``) and sums its
    messages into its own rows (``index_add_``).  The loss, a global sum
    over a global count, is the same on every rank, and
    ``torch.autograd.grad`` of it gives each rank the whole gradient of the
    params.  Collective: every rank calls it, forward and backward."""
    ag = axis_group(mesh, data_axes)

    def loss(params, g: GraphBatch) -> torch.Tensor:
        leaves, treedef = tree_flatten(params)
        params = tree_unflatten(treedef, list(_Replicated.apply(ag, *leaves)))
        n_local = g.x.shape[0] // ag.size
        m_local = g.edge_src.shape[0] // ag.size
        offset = ag.index * n_local
        rows, edges = slice(offset, offset + n_local), slice(ag.index * m_local,
                                                             (ag.index + 1) * m_local)
        src, dst = g.edge_src[edges].long(), g.edge_dst[edges].long()
        emask, nmask, y = g.edge_mask[edges], g.node_mask[rows], g.y[rows]
        e_attr = g.edge_attr[edges] if g.edge_attr is not None else torch.zeros(
            (m_local, cfg.d_edge_in), dtype=cfg.dtype, device=g.x.device)
        dst_local = (dst - offset).clamp(0, n_local - 1)
        h = g.x[rows].to(cfg.dtype) @ params["embed_x"]
        e = e_attr.to(cfg.dtype) @ params["embed_e"]
        for lw in params["layers"]:
            h_full = _gather_nodes(h, ag)
            h_src, h_dst = h_full[src], h_full[dst]
            e_new = h_dst @ lw["A"] + h_src @ lw["B"] + e @ lw["C"]
            eta = torch.sigmoid(e_new)
            num = segment_agg(eta * (h_src @ lw["V"]), dst_local, emask, n_local, "sum")
            den = segment_agg(eta, dst_local, emask, n_local, "sum")
            h = h + F.relu(_norm(h @ lw["U"] + num / (den + 1e-6), lw["ln_h"]))
            e = e + F.relu(_norm(e_new, lw["ln_e"]))
        logp = torch.log_softmax((h @ params["readout"]).float(), dim=-1)
        ll = logp.gather(1, y.long()[:, None])[:, 0]
        total = _SumOver.apply(torch.where(nmask, ll, 0.0).sum(), ag)
        count = sum_over(nmask.sum(), ag)
        return -total / count.clamp_min(1)

    return loss
