"""The substrate's model zoo, the port of ``repro.models`` (plain torch
functions over params dicts; the kernels K4 and K6 on the card).

transformer.py : decoder LMs (dense GQA, SWA, MoE); MLA raises until ported
recsys/        : xDeepFM

The GNN family (``repro.models.gnn``) is not ported yet (ROADMAP.md Queue 1,
item 12).
"""
from repro_torch.models import transformer
from repro_torch.models.recsys import xdeepfm

__all__ = ["transformer", "xdeepfm"]
