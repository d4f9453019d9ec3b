"""gatedgcn [arXiv:2003.00982]: 16 layers, d_hidden=70, gated aggregator.

The port of ``repro.configs.gatedgcn_cfg``.  Its dst-local variant's loss
(``variant`` "dstlocal" or "opt", JAX's choice) is
``models.gnn.gatedgcn.make_dstlocal_loss``, its step
``configs.gnn_cells.make_gnn_train_step``; the baseline's,
``gatedgcn.make_sharded_loss`` (JAX's layout).
"""
from __future__ import annotations

import torch

from repro_torch.configs.cell import data_axes_of
from repro_torch.configs.gnn_cells import GNN_SHAPES, gnn_train_cell, shape_dims
from repro_torch.models.gnn import gatedgcn

ARCH_ID = "gatedgcn"
FAMILY = "gnn"
SHAPES = tuple(GNN_SHAPES)
D_EDGE = 8


def full_config(d_in: int = 1433) -> gatedgcn.GatedGCNConfig:
    return gatedgcn.GatedGCNConfig(
        name=ARCH_ID, n_layers=16, d_in=d_in, d_edge_in=D_EDGE, d_hidden=70, n_classes=8
    )


def smoke_config() -> gatedgcn.GatedGCNConfig:
    return gatedgcn.GatedGCNConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_in=8, d_edge_in=4, d_hidden=16, n_classes=4
    )


def cells(shape: str, mesh, variant: str = "baseline"):
    _, _, d_feat = shape_dims(shape)
    cfg = full_config(d_in=d_feat)
    if variant in ("dstlocal", "opt") and mesh is not None:
        # hillclimbed message passing: dst-local edge layout, one node-stream
        # all-gather a layer
        loss = gatedgcn.make_dstlocal_loss(cfg, mesh, data_axes_of(mesh), local=True)
    else:
        loss = gatedgcn.make_sharded_loss(cfg, mesh, data_axes_of(mesh))
    return gnn_train_cell(
        ARCH_ID, shape, mesh,
        loss_fn=loss,
        init_fn=lambda: gatedgcn.init_params(cfg, torch.Generator(), device="meta"),
        d_edge=D_EDGE,
    )
