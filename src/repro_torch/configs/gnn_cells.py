"""The GNN family's shapes and training step, the port of
``repro.configs.gnn_cells``'s ``GNN_SHAPES``, ``_pad_to``, ``shape_dims``
and the ``train_step`` of ``gnn_train_cell``.

Shapes (assignment):
  full_graph_sm  n=2,708   m=10,556       d_feat=1,433  (full-batch, Cora)
  minibatch_lg   n=232,965 m=114,615,892  batch=1,024 fanout 15-10 (sampled)
  ogb_products   n=2,449,029 m=61,859,140 d_feat=100    (full-batch-large)
  molecule       30 nodes / 64 edges x batch 128        (batched-small)

Sampled training takes the per-step block (1024 seeds -> 16,384 1-hop ->
153,600 2-hop nodes, 168,960 edges) that the neighbour sampler
(``repro_torch.graph.sampler``) produces.  Full-batch cells take the whole
padded graph; vertices and edges shard over the DP axes.

``gnn_train_cell`` gives a dry-run cell (``launch.dryrun``) whose ``fn`` is
one rank's step over its block of the graph: each arch's loss is its
``make_sharded_loss`` (gatedgcn's dst-local variant ``make_dstlocal_loss``),
one rank's program over a graph split over the data axes.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.cell import CellSpec, TensorSpec, data_axes_of, host_step, specs_of
from repro_torch.graph.sampler import block_shapes
from repro_torch.launch.mesh import P
from repro_torch.models.gnn.layers import GraphBatch
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.tree import tree_leaves

GNN_SHAPES = {
    "full_graph_sm": dict(n=2708, m=10556, d_feat=1433, kind="train"),
    "minibatch_lg": dict(
        n=232_965, m=114_615_892, batch_nodes=1024, fanout=(15, 10),
        d_feat=602, kind="train",
    ),
    "ogb_products": dict(n=2_449_029, m=61_859_140, d_feat=100, kind="train"),
    "molecule": dict(n=30 * 128, m=64 * 128, d_feat=16, kind="train"),
}


def _pad_to(x: int, mult: int = 512) -> int:
    """Node/edge counts pad to a DP-divisible multiple (the data pipeline
    pads with masked entries; 512 covers every mesh's DP extent)."""
    return ((x + mult - 1) // mult) * mult


def shape_dims(shape: str):
    """(n, m, d_feat) of a shape, n and m padded."""
    info = GNN_SHAPES[shape]
    if shape == "minibatch_lg":
        n, m = block_shapes(info["batch_nodes"], info["fanout"])
        return _pad_to(n), _pad_to(m), info["d_feat"]
    return _pad_to(info["n"]), _pad_to(info["m"]), info["d_feat"]


def make_gnn_train_step(loss_fn: Callable, mesh):
    """The ``train_step`` of JAX's ``gnn_train_cell``: ``train_step(params,
    opt_state, g) -> (params, opt_state, metrics)``, the loss and its
    gradient, the warmup + cosine learning rate (base 1e-3, warmup 100,
    total 10,000) and AdamW, params and optimizer state replicated over
    ``mesh`` and updated in place.  ``loss_fn(params, g)`` gives the same
    loss and the whole gradient on every rank of ``mesh`` (as
    ``gatedgcn.make_dstlocal_loss``'s does), so the step adds no exchange
    of its own; every rank calls it."""
    del mesh   # the replication is loss_fn's: its gradient is the same on every rank

    def train_step(params, opt_state, g):
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss = loss_fn(params, g)
        # a leaf the loss does not reach (gatedgcn's last edge update) gets 0, as jax.grad's
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        lr = cosine_schedule(opt_state.step, 1e-3, warmup=100, total=10_000)
        params, opt_state, metrics = adamw_update(grads, opt_state, params, lr)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# dry-run cells
# ---------------------------------------------------------------------------

def graph_specs(n: int, m: int, d_feat: int, with_pos: bool, d_edge, n_classes: int = 8):
    """The ``TensorSpec`` GraphBatch (JAX's ``graph_specs``)."""
    del n_classes
    return GraphBatch(
        x=TensorSpec((n, d_feat), torch.float32),
        edge_src=TensorSpec((m,), torch.int32),
        edge_dst=TensorSpec((m,), torch.int32),
        edge_mask=TensorSpec((m,), torch.bool),
        node_mask=TensorSpec((n,), torch.bool),
        edge_attr=TensorSpec((m, d_edge), torch.float32) if d_edge else None,
        pos=TensorSpec((n, 3), torch.float32) if with_pos else None,
        y=TensorSpec((n,), torch.int32),
    )


def graph_pspecs(mesh, with_pos: bool, d_edge):
    """Vertices and edges both shard over the DP axes (model axis free for
    feature-dim sharding on wide GNNs)."""
    axes = data_axes_of(mesh)
    lead = axes if len(axes) > 1 else axes[0]
    return GraphBatch(
        x=P(lead, None),
        edge_src=P(lead),
        edge_dst=P(lead),
        edge_mask=P(lead),
        node_mask=P(lead),
        edge_attr=P(lead, None) if d_edge else None,
        pos=P(lead, None) if with_pos else None,
        y=P(lead),
    )


def gnn_train_cell(arch_id: str, shape: str, mesh, loss_fn: Callable,
                   init_fn: Callable, with_pos: bool = False, d_edge=None,
                   extra_meta: Optional[Dict] = None) -> CellSpec:
    """JAX's ``gnn_train_cell``.  ``loss_fn(params, g)`` is one rank's loss
    over its block of the graph.  ``init_fn()`` makes the params on
    ``meta``.  Params and optimizer state are whole on every rank; ``fn``
    is ``make_gnn_train_step``'s step."""
    from repro_torch.optim import adamw_init

    n, m, d_feat = shape_dims(shape)
    g_specs = graph_specs(n, m, d_feat, with_pos, d_edge)
    params = init_fn()
    params_specs = specs_of(params)
    opt_specs = specs_of(adamw_init(params))
    step = make_gnn_train_step(loss_fn, mesh)
    return CellSpec(
        arch=arch_id, shape=shape, kind="train",
        fn=lambda params, opt_state, g: step(params, host_step(opt_state), g),
        args=(params_specs, opt_specs, g_specs),
        placements=(P(), P(), graph_pspecs(mesh, with_pos, d_edge)),
        out_placements=(P(), P(), None),
        donate=(0, 1),
        meta=dict(n_nodes=n, n_edges=m, d_feat=d_feat, **(extra_meta or {})),
    )
