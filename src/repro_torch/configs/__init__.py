"""Architecture registry, the port of ``repro.configs``: one module per
architecture, under the JAX package's ids.

Each arch module exposes:
  ARCH_ID        str
  FAMILY         'lm' | 'gnn' | 'recsys'
  full_config()  the published config
  smoke_config() a reduced same-family config (CPU tests)
  SHAPES         tuple of shape names valid for this arch

The JAX package's ``cells`` (dry-run lowering specs) wait for the dry run
(ROADMAP.md Queue 1, item 12.5); what they lower runs here: ``cell``'s mesh
helpers, ``lm_cells.make_train_step`` and ``gnn_cells.make_gnn_train_step``.
The one id of the JAX package's registry that is not ported yet raises
``KeyError`` in ``get_arch``, naming the ROADMAP item that ports it.
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
}
# the JAX registry's other ids -> what ports them
_NOT_PORTED = {
    "reachability-oracle": "the dry run and its cells (ROADMAP.md Queue 1, item 12.5)",
}

ALL_ARCHS = tuple(_ARCH_MODULES)
ASSIGNED_ARCHS = ALL_ARCHS


def get_arch(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise KeyError(f"{arch_id!r} is not ported yet: {_NOT_PORTED[arch_id]}")
    return importlib.import_module(_ARCH_MODULES[arch_id])
