"""graphcast [arXiv:2212.12794]: 16 processor layers, d_hidden=512,
mesh_refinement=6, sum aggregator, n_vars=227.

Shape mapping: the generic GNN shapes give (n_grid, n_mesh_edges); the mesh
node set is n_grid/8 (the icosahedral mesh at refinement 6 has ~41k nodes for
the 1-degree 65k-cell grid -- the /8 ratio mirrors that), g2m/m2g edge counts
are 2x grid nodes (nearest-mesh-triangle connectivity). n_vars=227 always
(the arch defines its feature width; the shape's d_feat is superseded).

The port of ``repro.configs.graphcast_cfg``; ``batch_specs`` and ``cells``
wait for the dry-run port.
"""
from __future__ import annotations

import torch

from repro_torch.configs.gnn_cells import GNN_SHAPES, _pad_to, shape_dims
from repro_torch.models.gnn import graphcast

ARCH_ID = "graphcast"
FAMILY = "gnn"
SHAPES = tuple(GNN_SHAPES)


def full_config() -> graphcast.GraphCastConfig:
    return graphcast.GraphCastConfig(
        name=ARCH_ID, n_layers=16, d_hidden=512, n_vars=227, mesh_refinement=6,
        dtype=torch.bfloat16,
    )


def smoke_config() -> graphcast.GraphCastConfig:
    return graphcast.GraphCastConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_hidden=32, n_vars=11,
        mesh_refinement=1, dtype=torch.float32,
    )


def mesh_dims(shape: str):
    """(n_grid, n_mesh, m_g2m, m_mesh, m_m2g) of a shape."""
    n_grid, m_mesh, _ = shape_dims(shape)
    n_mesh = _pad_to(max(n_grid // 8, 64))
    m_g2m = 2 * n_grid
    m_m2g = 2 * n_grid
    return n_grid, n_mesh, m_g2m, _pad_to(min(m_mesh, 16 * n_mesh)), m_m2g
