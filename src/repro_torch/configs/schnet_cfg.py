"""schnet [arXiv:1706.08566]: 3 interactions, d=64, 300 RBFs, cutoff 10.
Positions are synthesized for non-molecular shape cells.

The port of ``repro.configs.schnet_cfg``.  Its ``loss_fn`` has no
per-rank program over more than one data rank.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.cell import dp_size
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
        loss_fn=partial(schnet.loss_fn, cfg) if dp_size(mesh) == 1 else None,
        init_fn=lambda: schnet.init_params(cfg, torch.Generator(), device="meta"),
        with_pos=True,
    )
