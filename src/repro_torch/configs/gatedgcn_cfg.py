"""gatedgcn [arXiv:2003.00982]: 16 layers, d_hidden=70, gated aggregator.

The port of ``repro.configs.gatedgcn_cfg``; ``cells`` (and its dst-local
variant) waits for the dry-run port and for training's multi-device half.
"""
from __future__ import annotations

from repro_torch.configs.gnn_cells import GNN_SHAPES
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
