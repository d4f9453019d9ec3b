"""The substrate's model zoo, the port of ``repro.models`` (plain torch
functions over params dicts; the kernels K4 and K6 on the card).

transformer.py : decoder LMs (dense GQA, SWA, MoE, MLA)
gnn/           : GCN (its aggregation on K5), GatedGCN, SchNet, GraphCast
recsys/        : xDeepFM
"""
from repro_torch.models import gnn, transformer
from repro_torch.models.recsys import xdeepfm

__all__ = ["gnn", "transformer", "xdeepfm"]
