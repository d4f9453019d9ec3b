"""SchNet (Schuett et al., arXiv:1706.08566), the port of
``repro.models.gnn.schnet`` -- continuous-filter conv GNN.

Assigned config: 3 interactions, d=64, 300 RBFs, cutoff 10 A.
cfconv: m_ij = x_j * W_filter(rbf(|r_i - r_j|));  x_i += MLP(sum_j m_ij).
The filter is a per-feature vector an edge, so the aggregation is torch's
``index_add_`` (``segment_agg``), not K5.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
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


def forward(cfg: SchNetConfig, params, g: GraphBatch) -> torch.Tensor:
    """g.x holds integer atom types in column 0, g.pos the coordinates.
    Returns each node's energy [n, 1], 0 at masked nodes."""
    n = g.x.shape[0]
    z = g.x[:, 0].to(torch.int32).clamp(0, cfg.n_atom_types - 1)
    x = params["embed"][z.long()]
    ri, rj = g.pos[g.edge_dst.long()], g.pos[g.edge_src.long()]
    dist = torch.sqrt(((ri - rj) ** 2).sum(-1) + 1e-12)
    rbf = _rbf(dist, cfg).to(cfg.dtype)
    # cosine cutoff envelope
    env = 0.5 * (torch.cos(math.pi * (dist / cfg.cutoff).clamp(0, 1)) + 1.0)
    for iw in params["interactions"]:
        w_f = mlp_apply(iw["filter"], rbf, act=_ssp) * env[:, None].to(cfg.dtype)
        h = mlp_apply(iw["w_in"], x)
        msg = h[g.edge_src.long()] * w_f
        agg = segment_agg(msg, g.edge_dst, g.edge_mask, n, "sum")
        x = x + mlp_apply(iw["update"], agg, act=_ssp)
    e_atom = mlp_apply(params["out"], x, act=_ssp)
    return torch.where(g.node_mask[:, None], e_atom, 0.0)


def loss_fn(cfg: SchNetConfig, params, g: GraphBatch) -> torch.Tensor:
    """Energy regression: the per-node energies sum to the target."""
    total = forward(cfg, params, g).sum()
    target = g.y.sum() if g.y is not None else 0.0
    return (total - target) ** 2 / g.node_mask.sum().clamp_min(1)
