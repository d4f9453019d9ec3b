"""GCN (Kipf & Welling, arXiv:1609.02907), the port of
``repro.models.gnn.gcn`` -- gcn-cora config: 2L, d=16.

Each layer's aggregation, ``sum over i's valid in-edges e of coeff[e] *
h[src[e]]`` with the symmetric normalisation ``gcn_sym_coeff``, is one K5
launch (``repro_torch.kernels.ops.ell_spmm``, a hand-written CUDA kernel on
the card, its plain version on the CPU) over the graph's ELL rows
(``ell_from_edges``, built once a graph), where the JAX package gathers
and segment-sums: ``n_layers`` K5 launches a forward.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.gnn.layers import GraphBatch, ell_from_edges, gcn_sym_coeff
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


def graph_ell(g: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ELL rows (nbr, wgt) of ``g``'s aggregation: its valid in-edges by
    destination, weighted by ``gcn_sym_coeff``."""
    n = g.x.shape[0]
    coeff = gcn_sym_coeff(g.edge_src, g.edge_dst, g.edge_mask, n)
    return ell_from_edges(g.edge_src, g.edge_dst, g.edge_mask, coeff, n)


@torch.no_grad()
def forward(cfg: GCNConfig, params, g: GraphBatch,
            ell: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """[n, n_classes] logits.  ``ell`` is ``graph_ell(g)``, made here when
    not given (a caller running several forwards over one graph makes it
    once).  Each layer: h = x W, x = K5(h) + h (the self loop), relu but
    after the last."""
    nbr, wgt = graph_ell(g) if ell is None else ell
    x = g.x.to(cfg.dtype)
    for i, layer in enumerate(params):
        h = x @ layer["w"]
        x = ops.ell_spmm(nbr, wgt, h) + h
        if i < len(params) - 1:
            x = F.relu(x)
    return x


@torch.no_grad()
def loss_fn(cfg: GCNConfig, params, g: GraphBatch, ell=None) -> torch.Tensor:
    """Node classification cross-entropy over ``g.node_mask``'s nodes."""
    logp = torch.log_softmax(forward(cfg, params, g, ell).float(), dim=-1)
    ll = logp.gather(1, g.y.long()[:, None])[:, 0]
    return -torch.where(g.node_mask, ll, 0.0).sum() / g.node_mask.sum().clamp_min(1)
