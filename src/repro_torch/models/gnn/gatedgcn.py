"""GatedGCN (Bresson & Laurent; benchmarking config of arXiv:2003.00982), the
port of ``repro.models.gnn.gatedgcn``'s ``forward`` and ``loss_fn``.

Per layer, with explicit edge features:
  e'_ij = A h_i + B h_j + C e_ij;      eta_ij = sigmoid(e'_ij)
  h'_i  = h_i U + ( sum_j eta_ij * (h_j V) ) / ( sum_j eta_ij + eps )
residual + LayerNorm on both node and edge streams.
Assigned config: 16 layers, d_hidden=70, gated aggregator.

The messages are per-feature vectors (eta is [m, d]), not one weight an
edge, so the aggregation is torch's ``index_add_`` (``segment_agg``), not K5.
The JAX package's dst-local distributed loss (``make_dstlocal_loss``) waits
for the multi-device half of training (ROADMAP.md Queue 1, item 12.3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.gnn.layers import GraphBatch, segment_agg
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
