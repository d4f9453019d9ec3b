"""The GNN family, the port of ``repro.models.gnn``: GCN (its aggregation on
K5), GatedGCN, SchNet and GraphCast, forward and loss."""
from repro_torch.models.gnn import gatedgcn, gcn, graphcast, schnet
from repro_torch.models.gnn.layers import GraphBatch, segment_agg

__all__ = ["GraphBatch", "segment_agg", "gcn", "gatedgcn", "schnet", "graphcast"]
