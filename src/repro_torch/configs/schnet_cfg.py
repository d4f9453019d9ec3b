"""schnet [arXiv:1706.08566]: 3 interactions, d=64, 300 RBFs, cutoff 10.
Positions are synthesized for non-molecular shape cells.

The port of ``repro.configs.schnet_cfg``; ``cells`` waits for the dry-run
port.
"""
from __future__ import annotations

from repro_torch.configs.gnn_cells import GNN_SHAPES
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
