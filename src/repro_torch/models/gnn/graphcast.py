"""GraphCast-style encoder-processor-decoder mesh GNN (arXiv:2212.12794), the
port of ``repro.models.gnn.graphcast``.

Assigned config: 16 processor layers, d_hidden=512, sum aggregator,
n_vars=227, mesh_refinement=6.

Three node/edge sets:
  grid nodes (n_g, 227 vars) --g2m--> mesh nodes (n_m) : encoder
  mesh nodes --mesh edges--> mesh nodes x16            : processor
  mesh nodes --m2g--> grid nodes                       : decoder -> 227 vars

Every block is an edge-MLP message + sum segment aggregate + node-MLP update
with residuals (MeshGraphNet recipe).  The messages are MLP outputs a
feature each, so the aggregation is torch's ``index_add_``, not K5.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.gnn.layers import mlp_apply, mlp_init, segment_sum
from repro_torch.models.jax_params import tree_from_jax


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    mesh_refinement: int = 6
    dtype: torch.dtype = torch.bfloat16


class MeshBatch(NamedTuple):
    """Static-shape weather state + mesh topology."""

    grid_x: torch.Tensor      # f32[n_g, n_vars]
    g2m_src: torch.Tensor     # int32[m_g2m] grid ids
    g2m_dst: torch.Tensor     # int32[m_g2m] mesh ids
    mesh_src: torch.Tensor    # int32[m_mesh]
    mesh_dst: torch.Tensor    # int32[m_mesh]
    m2g_src: torch.Tensor     # int32[m_m2g] mesh ids
    m2g_dst: torch.Tensor     # int32[m_m2g] grid ids
    target: torch.Tensor      # f32[n_g, n_vars]


def init_params(cfg: GraphCastConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights with JAX's tree, shapes and scales, drawn from
    ``generator`` (its numbers are not ``jax.random``'s)."""
    dev = resolve_device(device)
    d, dt = cfg.d_hidden, cfg.dtype

    def mlp(sizes):
        return mlp_init(generator, sizes, dt, dev)

    return {
        "grid_enc": mlp([cfg.n_vars, d, d]),
        "g2m_edge": mlp([2 * d, d, d]),
        "g2m_node": mlp([2 * d, d, d]),
        "m2g_edge": mlp([2 * d, d, d]),
        "m2g_node": mlp([2 * d, d, cfg.n_vars]),
        "proc": [{"edge": mlp([2 * d, d, d]), "node": mlp([2 * d, d, d])}
                 for _ in range(cfg.n_layers)],
    }


def params_from_jax(cfg: GraphCastConfig, params, device="cuda") -> dict:
    return tree_from_jax(params, resolve_device(device))


def _mp(edge_mlp, node_mlp, h_src_nodes, h_dst_nodes, src, dst, n_dst):
    """One message-passing block: edge MLP on (src, dst) pairs -> sum agg ->
    node MLP on (node, agg) -> residual."""
    src, dst = src.long(), dst.long()
    msg = mlp_apply(edge_mlp, torch.cat([h_src_nodes[src], h_dst_nodes[dst]], dim=-1))
    agg = segment_sum(msg, dst, n_dst)
    return h_dst_nodes + mlp_apply(node_mlp, torch.cat([h_dst_nodes, agg], dim=-1))


def forward(cfg: GraphCastConfig, params, b: MeshBatch, n_mesh: int) -> torch.Tensor:
    """The next state, grid_x + the decoded delta: [n_g, n_vars] in grid_x's
    dtype."""
    n_g = b.grid_x.shape[0]
    h_g = mlp_apply(params["grid_enc"], b.grid_x.to(cfg.dtype))
    h_m = torch.zeros((n_mesh, cfg.d_hidden), dtype=cfg.dtype, device=h_g.device)
    # encoder: grid -> mesh
    h_m = _mp(params["g2m_edge"], params["g2m_node"], h_g, h_m, b.g2m_src, b.g2m_dst, n_mesh)
    # processor
    for lw in params["proc"]:
        h_m = _mp(lw["edge"], lw["node"], h_m, h_m, b.mesh_src, b.mesh_dst, n_mesh)
    # decoder: mesh -> grid (residual update in physical space)
    src, dst = b.m2g_src.long(), b.m2g_dst.long()
    msg = mlp_apply(params["m2g_edge"], torch.cat([h_m[src], h_g[dst]], dim=-1))
    agg = segment_sum(msg, dst, n_g)
    delta = mlp_apply(params["m2g_node"], torch.cat([h_g, agg], dim=-1))
    return b.grid_x + delta.to(b.grid_x.dtype)


def loss_fn(cfg: GraphCastConfig, params, b: MeshBatch, n_mesh: int) -> torch.Tensor:
    return ((forward(cfg, params, b, n_mesh) - b.target) ** 2).mean()
