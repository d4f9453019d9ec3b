"""schnet [arXiv:1706.08566]: 3 interactions, d=64, 300 RBFs, cutoff 10.
Positions are synthesized for non-molecular shape cells.

The port of ``repro.configs.schnet_cfg``.  A cell's loss is
``schnet.make_sharded_loss``, one rank's over its block of the graph.
"""
from __future__ import annotations

import torch

from repro_torch.configs.cell import data_axes_of
from repro_torch.configs.gnn_cells import GNN_SHAPES, gnn_train_cell
from repro_torch.models.gnn import schnet

ARCH_ID = "schnet"
FAMILY = "gnn"
SHAPES = tuple(GNN_SHAPES)


def full_config() -> schnet.SchNetConfig:
    return schnet.SchNetConfig(
        name=ARCH_ID, n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0
    )


def smoke_config() -> schnet.SchNetConfig:
    return schnet.SchNetConfig(
        name=ARCH_ID + "-smoke", n_interactions=2, d_hidden=16, n_rbf=20, cutoff=5.0
    )


def cells(shape: str, mesh, variant: str = "baseline"):
    cfg = full_config()
    return gnn_train_cell(
        ARCH_ID, shape, mesh,
        loss_fn=schnet.make_sharded_loss(cfg, mesh, data_axes_of(mesh)),
        init_fn=lambda: schnet.init_params(cfg, torch.Generator(), device="meta"),
        with_pos=True,
    )
