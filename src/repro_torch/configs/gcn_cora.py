"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden=16, mean/sym aggregator.
d_in follows the shape cell's d_feat (1433 on full_graph_sm = Cora).

The port of ``repro.configs.gcn_cora``.  A cell's loss is
``gcn.make_sharded_loss``, one rank's over its block of the graph.
"""
from __future__ import annotations

import torch

from repro_torch.configs.cell import data_axes_of
from repro_torch.configs.gnn_cells import GNN_SHAPES, gnn_train_cell, shape_dims
from repro_torch.models.gnn import gcn

ARCH_ID = "gcn-cora"
FAMILY = "gnn"
SHAPES = tuple(GNN_SHAPES)


def full_config(d_in: int = 1433) -> gcn.GCNConfig:
    return gcn.GCNConfig(name=ARCH_ID, n_layers=2, d_in=d_in, d_hidden=16, n_classes=7)


def smoke_config() -> gcn.GCNConfig:
    return gcn.GCNConfig(name=ARCH_ID + "-smoke", n_layers=2, d_in=8, d_hidden=8, n_classes=4)


def cells(shape: str, mesh, variant: str = "baseline"):
    _, _, d_feat = shape_dims(shape)
    cfg = full_config(d_in=d_feat)
    return gnn_train_cell(
        ARCH_ID, shape, mesh,
        loss_fn=gcn.make_sharded_loss(cfg, mesh, data_axes_of(mesh)),
        init_fn=lambda: gcn.init_params(cfg, torch.Generator(), device="meta"),
    )
