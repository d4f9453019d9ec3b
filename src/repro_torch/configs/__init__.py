"""Architecture registry, the port of ``repro.configs``: one module per
architecture, under the JAX package's ids.

Each arch module exposes:
  ARCH_ID        str
  FAMILY         'lm' | 'gnn' | 'recsys' | 'oracle'
  full_config()  the published config
  smoke_config() a reduced same-family config (CPU tests)
  SHAPES         tuple of shape names valid for this arch
  cells(shape, mesh, variant='baseline') -> CellSpec (see configs.cell):
                 one rank's step, its global argument specs and placements,
                 what ``launch.dryrun`` traces
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "graphcast": "repro_torch.configs.graphcast_cfg",
    "schnet": "repro_torch.configs.schnet_cfg",
    "gatedgcn": "repro_torch.configs.gatedgcn_cfg",
    "xdeepfm": "repro_torch.configs.xdeepfm_cfg",
    "reachability-oracle": "repro_torch.configs.reachability",
}

ALL_ARCHS = tuple(_ARCH_MODULES)
ASSIGNED_ARCHS = tuple(a for a in ALL_ARCHS if a != "reachability-oracle")


def get_arch(arch_id: str):
    return importlib.import_module(_ARCH_MODULES[arch_id])
