"""SchNet (Schuett et al., arXiv:1706.08566), the port of
``repro.models.gnn.schnet`` -- continuous-filter conv GNN.

Assigned config: 3 interactions, d=64, 300 RBFs, cutoff 10 A.
cfconv: m_ij = x_j * W_filter(rbf(|r_i - r_j|));  x_i += MLP(sum_j m_ij).
The filter is a per-feature vector an edge, so the aggregation is torch's
``index_add_`` (``segment_agg``), not K5.  ``make_sharded_loss`` is
``loss_fn`` as one rank's program over a graph split over a mesh's data
axes, exchanging through ``repro_torch.dist.sharded``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist import sharded
from repro_torch.launch.mesh import ONE_RANK, AxisGroup, axis_group, gather_rows, sum_over
from repro_torch.models.gnn.layers import GraphBatch, mlp_apply, mlp_init, segment_agg
from repro_torch.models.jax_params import tree_from_jax


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100
    dtype: torch.dtype = torch.float32


def init_params(cfg: SchNetConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights with JAX's tree, shapes and scales, drawn from
    ``generator`` (its numbers are not ``jax.random``'s)."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    return {
        "embed": torch.randn((cfg.n_atom_types, d), generator=generator, device=dev)
        .mul_(0.1).to(cfg.dtype),
        "out": mlp_init(generator, [d, d // 2, 1], cfg.dtype, dev),
        "interactions": [{"filter": mlp_init(generator, [cfg.n_rbf, d, d], cfg.dtype, dev),
                          "w_in": mlp_init(generator, [d, d], cfg.dtype, dev),
                          "update": mlp_init(generator, [d, d, d], cfg.dtype, dev)}
                         for _ in range(cfg.n_interactions)],
    }


def params_from_jax(cfg: SchNetConfig, params, device="cuda") -> dict:
    return tree_from_jax(params, resolve_device(device))


def _rbf(dist: torch.Tensor, cfg: SchNetConfig) -> torch.Tensor:
    """Gaussian radial basis on [0, cutoff]; dist [m] -> [m, n_rbf]."""
    centers = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, device=dist.device)
    gamma = 10.0 / cfg.cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def _ssp(x: torch.Tensor) -> torch.Tensor:  # shifted softplus, SchNet's activation
    return F.softplus(x) - math.log(2.0)


def _energies(cfg: SchNetConfig, params, g: GraphBatch, ag: AxisGroup) -> torch.Tensor:
    """This rank's nodes' energies [n/P, 1], 0 at masked nodes: ``g`` holds
    its node rows (x, pos, node_mask) and its block of edges with global
    ids (JAX's layout).  ``pos`` is gathered once (``gather_rows``, no
    gradient); each interaction gathers ``w_in``'s output rows
    (``dist.sharded.gather``), sums the rank's messages times the filter
    and the envelope into an n-wide partial and reduce-scatters it onto
    the owners' rows (``dist.sharded.scatter_sum``); the update MLP is
    local.  One rank: ``forward``."""
    n = g.x.shape[0] * ag.size
    src, dst = g.edge_src.long(), g.edge_dst.long()
    z = g.x[:, 0].to(torch.int32).clamp(0, cfg.n_atom_types - 1)
    x = params["embed"][z.long()]
    pos = gather_rows(g.pos, ag) if ag.size > 1 else g.pos
    ri, rj = pos[dst], pos[src]
    dist = torch.sqrt(((ri - rj) ** 2).sum(-1) + 1e-12)
    rbf = _rbf(dist, cfg).to(cfg.dtype)
    # cosine cutoff envelope
    env = 0.5 * (torch.cos(math.pi * (dist / cfg.cutoff).clamp(0, 1)) + 1.0)
    for iw in params["interactions"]:
        w_f = mlp_apply(iw["filter"], rbf, act=_ssp) * env[:, None].to(cfg.dtype)
        h = sharded.gather(mlp_apply(iw["w_in"], x), ag)
        agg = segment_agg(h[src] * w_f, g.edge_dst, g.edge_mask, n, "sum")
        x = x + mlp_apply(iw["update"], sharded.scatter_sum(agg, ag), act=_ssp)
    e_atom = mlp_apply(params["out"], x, act=_ssp)
    return torch.where(g.node_mask[:, None], e_atom, 0.0)


def _loss(cfg: SchNetConfig, params, g: GraphBatch, ag: AxisGroup) -> torch.Tensor:
    """``(sum of e_atom - sum of y)^2 / count``, each sum over every rank's
    rows; the same scalar on every rank."""
    total = sharded.sum_over_ranks(_energies(cfg, params, g, ag).sum(), ag)
    target = sum_over(g.y.sum(), ag) if g.y is not None else 0.0
    return (total - target) ** 2 / sum_over(g.node_mask.sum(), ag).clamp_min(1)


def forward(cfg: SchNetConfig, params, g: GraphBatch) -> torch.Tensor:
    """g.x holds integer atom types in column 0, g.pos the coordinates.
    Returns each node's energy [n, 1], 0 at masked nodes."""
    return _energies(cfg, params, g, ONE_RANK)


def loss_fn(cfg: SchNetConfig, params, g: GraphBatch) -> torch.Tensor:
    """Energy regression: the per-node energies sum to the target."""
    return _loss(cfg, params, g, ONE_RANK)


def make_sharded_loss(cfg: SchNetConfig, mesh, data_axes=("data",)):
    """``loss_fn`` as one rank's program over a graph split over ``mesh``'s
    ``data_axes`` (``None``: one rank) in JAX's layout: ``g`` holds this
    rank's n/P node rows (x, pos, node_mask, y) and its m/P edges (global
    ids).  The loss is ``loss_fn``'s, the same on every rank, and
    ``torch.autograd.grad`` of it gives each rank the whole gradient of the
    params (``dist.sharded.Replicated``).  Collective: every rank calls it,
    forward and backward."""
    ag = ONE_RANK if mesh is None else axis_group(mesh, data_axes)

    def loss(params, g: GraphBatch) -> torch.Tensor:
        return _loss(cfg, sharded.replicated(params, ag), g, ag)

    return loss
