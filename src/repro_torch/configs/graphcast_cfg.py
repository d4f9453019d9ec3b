"""graphcast [arXiv:2212.12794]: 16 processor layers, d_hidden=512,
mesh_refinement=6, sum aggregator, n_vars=227.

Shape mapping: the generic GNN shapes give (n_grid, n_mesh_edges); the mesh
node set is n_grid/8 (the icosahedral mesh at refinement 6 has ~41k nodes for
the 1-degree 65k-cell grid -- the /8 ratio mirrors that), g2m/m2g edge counts
are 2x grid nodes (nearest-mesh-triangle connectivity). n_vars=227 always
(the arch defines its feature width; the shape's d_feat is superseded).

The port of ``repro.configs.graphcast_cfg``.  A cell's loss is
``graphcast.make_sharded_loss``, one rank's over its grid rows and its block
of each edge list, the mesh latents split over the data ranks too.
"""
from __future__ import annotations

import torch

from repro_torch.configs.cell import CellSpec, TensorSpec, data_axes_of, host_step, specs_of
from repro_torch.configs.gnn_cells import GNN_SHAPES, _pad_to, make_gnn_train_step, shape_dims
from repro_torch.launch.mesh import P
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


def batch_specs(shape: str, cfg: graphcast.GraphCastConfig):
    n_g, n_m, m_g2m, m_mesh, m_m2g = mesh_dims(shape)
    i32 = torch.int32
    return graphcast.MeshBatch(
        grid_x=TensorSpec((n_g, cfg.n_vars), torch.float32),
        g2m_src=TensorSpec((m_g2m,), i32),
        g2m_dst=TensorSpec((m_g2m,), i32),
        mesh_src=TensorSpec((m_mesh,), i32),
        mesh_dst=TensorSpec((m_mesh,), i32),
        m2g_src=TensorSpec((m_m2g,), i32),
        m2g_dst=TensorSpec((m_m2g,), i32),
        target=TensorSpec((n_g, cfg.n_vars), torch.float32),
    )


def cells(shape: str, mesh, variant: str = "baseline"):
    from repro_torch.optim import adamw_init

    cfg = full_config()
    n_g, n_m, m_g2m, m_mesh, m_m2g = mesh_dims(shape)
    axes = data_axes_of(mesh)
    lead = axes if len(axes) > 1 else axes[0]
    b_p = graphcast.MeshBatch(
        grid_x=P(lead, None),
        g2m_src=P(lead), g2m_dst=P(lead),
        mesh_src=P(lead), mesh_dst=P(lead),
        m2g_src=P(lead), m2g_dst=P(lead),
        target=P(lead, None),
    )
    params = graphcast.init_params(cfg, torch.Generator(), device="meta")
    step = make_gnn_train_step(graphcast.make_sharded_loss(cfg, mesh, n_m, axes), mesh)
    return CellSpec(
        arch=ARCH_ID, shape=shape, kind="train",
        fn=lambda params, opt_state, b: step(params, host_step(opt_state), b),
        args=(specs_of(params), specs_of(adamw_init(params)), batch_specs(shape, cfg)),
        placements=(P(), P(), b_p),
        out_placements=(P(), P(), None),
        donate=(0, 1),
        meta=dict(n_grid=n_g, n_mesh=n_m, m_mesh=m_mesh,
                  note="n_vars=227 supersedes shape d_feat"),
    )
