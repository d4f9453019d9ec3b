"""Deterministic synthetic data, the port of ``repro.data.synth``'s
``graph_batch_from_csr``: numpy's generator from the same seed, drawn in the
same order, so the arrays equal the JAX package's.  ``lm_batch`` and
``recsys_batch`` (drawn with ``jax.random``) wait for the training port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.models.gnn.layers import GraphBatch


def graph_batch_from_csr(g: CSRGraph, d_feat: int, seed: int = 0, n_classes: int = 8,
                         with_pos: bool = False, d_edge: int | None = None,
                         pad_edges_to: int | None = None, device="cuda") -> GraphBatch:
    """Wrap a host CSR graph as a padded GraphBatch on ``device``: normal node
    features, the edges then masked padding (ids 0), normal edge features,
    positions 3 x normal, labels in [0, n_classes)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = g.n
    src, dst = g.edges()
    m = src.shape[0]
    m_pad = pad_edges_to or m
    pad = m_pad - m
    if pad < 0:
        raise ValueError(f"{m} edges do not fit pad_edges_to = {m_pad}")

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    x = rng.standard_normal((n, d_feat)).astype(np.float32)
    edge_attr = rng.standard_normal((m_pad, d_edge)).astype(np.float32) if d_edge else None
    pos = 3.0 * rng.standard_normal((n, 3)).astype(np.float32) if with_pos else None
    y = rng.integers(0, n_classes, n).astype(np.int32)
    return GraphBatch(
        x=t(x),
        edge_src=t(np.concatenate([src, np.zeros(pad, np.int32)]).astype(np.int32)),
        edge_dst=t(np.concatenate([dst, np.zeros(pad, np.int32)]).astype(np.int32)),
        edge_mask=t(np.concatenate([np.ones(m, bool), np.zeros(pad, bool)])),
        node_mask=torch.ones(n, dtype=torch.bool, device=dev),
        edge_attr=None if edge_attr is None else t(edge_attr),
        pos=None if pos is None else t(pos),
        y=t(y),
    )
