"""GraphCast-style encoder-processor-decoder mesh GNN (arXiv:2212.12794), the
port of ``repro.models.gnn.graphcast``.

Assigned config: 16 processor layers, d_hidden=512, sum aggregator,
n_vars=227, mesh_refinement=6.

Three node/edge sets:
  grid nodes (n_g, 227 vars) --g2m--> mesh nodes (n_m) : encoder
  mesh nodes --mesh edges--> mesh nodes x16            : processor
  mesh nodes --m2g--> grid nodes                       : decoder -> 227 vars

Every block is an edge-MLP message + sum segment aggregate + node-MLP update
with residuals (MeshGraphNet recipe).  The messages are MLP outputs a
feature each, so the aggregation is torch's ``index_add_``, not K5.
``make_sharded_loss`` is ``loss_fn`` as one rank's program over a mesh's
data axes, exchanging through ``repro_torch.dist.sharded``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import sharded
from repro_torch.launch.mesh import ONE_RANK, AxisGroup, axis_group
from repro_torch.models.gnn.layers import mlp_apply, mlp_init, segment_sum
from repro_torch.models.jax_params import tree_from_jax


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    mesh_refinement: int = 6
    dtype: torch.dtype = torch.bfloat16


class MeshBatch(NamedTuple):
    """Static-shape weather state + mesh topology."""

    grid_x: torch.Tensor      # f32[n_g, n_vars]
    g2m_src: torch.Tensor     # int32[m_g2m] grid ids
    g2m_dst: torch.Tensor     # int32[m_g2m] mesh ids
    mesh_src: torch.Tensor    # int32[m_mesh]
    mesh_dst: torch.Tensor    # int32[m_mesh]
    m2g_src: torch.Tensor     # int32[m_m2g] mesh ids
    m2g_dst: torch.Tensor     # int32[m_m2g] grid ids
    target: torch.Tensor      # f32[n_g, n_vars]


def init_params(cfg: GraphCastConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights with JAX's tree, shapes and scales, drawn from
    ``generator`` (its numbers are not ``jax.random``'s)."""
    dev = resolve_device(device)
    d, dt = cfg.d_hidden, cfg.dtype

    def mlp(sizes):
        return mlp_init(generator, sizes, dt, dev)

    return {
        "grid_enc": mlp([cfg.n_vars, d, d]),
        "g2m_edge": mlp([2 * d, d, d]),
        "g2m_node": mlp([2 * d, d, d]),
        "m2g_edge": mlp([2 * d, d, d]),
        "m2g_node": mlp([2 * d, d, cfg.n_vars]),
        "proc": [{"edge": mlp([2 * d, d, d]), "node": mlp([2 * d, d, d])}
                 for _ in range(cfg.n_layers)],
    }


def params_from_jax(cfg: GraphCastConfig, params, device="cuda") -> dict:
    return tree_from_jax(params, resolve_device(device))


def _aggregate(edge_mlp, h_src_nodes, h_dst_nodes, src, dst, n_dst: int, ag: AxisGroup):
    """The edge MLP on a rank's (src, dst) pairs (global ids into the whole
    ``h_src_nodes`` and ``h_dst_nodes``), its messages summed into an
    ``n_dst``-wide partial (bfloat16 and float16 ones in float32),
    reduce-scattered onto the owners' rows (``dist.sharded.scatter_sum``)
    and rounded once to the model's dtype, as ``segment_sum`` rounds on one
    rank."""
    src, dst = src.long(), dst.long()
    msg = mlp_apply(edge_mlp, torch.cat([h_src_nodes[src], h_dst_nodes[dst]], dim=-1))
    wide = msg.float() if msg.dtype in (torch.bfloat16, torch.float16) else msg
    return sharded.scatter_sum(segment_sum(wide, dst, n_dst), ag).to(msg.dtype)


def _mp(edge_mlp, node_mlp, h_src_nodes, h_dst_nodes, h_own, src, dst, n_dst, ag):
    """One message-passing block: edge MLP on (src, dst) pairs -> sum agg ->
    node MLP on (node, agg) -> residual, at this rank's destination rows
    ``h_own`` (its block of ``h_dst_nodes``)."""
    agg = _aggregate(edge_mlp, h_src_nodes, h_dst_nodes, src, dst, n_dst, ag)
    return h_own + mlp_apply(node_mlp, torch.cat([h_own, agg], dim=-1))


def _predict(cfg: GraphCastConfig, params, b: MeshBatch, n_mesh: int,
             ag: AxisGroup) -> torch.Tensor:
    """This rank's rows of the next state, [n_g/P, n_vars] in grid_x's
    dtype: ``b`` holds its grid rows (grid_x, target) and its block of each
    edge list (global ids).  The mesh latents are split over the ranks as
    the grid rows are (rank r owns mesh nodes [r n_mesh/P, (r+1) n_mesh/P)),
    never held whole: every block gathers the source rows it reads
    (``dist.sharded.gather``, the grid stream once, the mesh latents once a
    block), sums the rank's messages into a partial over every destination
    and reduce-scatters it onto the owners, whose node MLPs run on their own
    rows alone.  So every exchange is a gather whose adjoint sums the
    ranks' gradients, or a reduce-scatter whose adjoint gathers them; no
    tensor is replicated but the params.  One rank: ``forward``."""
    if n_mesh % ag.size:
        raise ValueError(f"{n_mesh} mesh nodes do not split over {ag.size} ranks")
    n_g = b.grid_x.shape[0] * ag.size
    h_g = mlp_apply(params["grid_enc"], b.grid_x.to(cfg.dtype))
    h_g_all = sharded.gather(h_g, ag)
    # encoder: grid -> mesh (the mesh latents start at 0)
    h_m = torch.zeros((n_mesh, cfg.d_hidden), dtype=cfg.dtype, device=h_g.device)
    h_m = _mp(params["g2m_edge"], params["g2m_node"], h_g_all, h_m, h_m[:n_mesh // ag.size],
              b.g2m_src, b.g2m_dst, n_mesh, ag)
    # processor
    for lw in params["proc"]:
        h_m_all = sharded.gather(h_m, ag)
        h_m = _mp(lw["edge"], lw["node"], h_m_all, h_m_all, h_m, b.mesh_src, b.mesh_dst,
                  n_mesh, ag)
    # decoder: mesh -> grid (residual update in physical space)
    agg = _aggregate(params["m2g_edge"], sharded.gather(h_m, ag), h_g_all, b.m2g_src,
                     b.m2g_dst, n_g, ag)
    delta = mlp_apply(params["m2g_node"], torch.cat([h_g, agg], dim=-1))
    return b.grid_x + delta.to(b.grid_x.dtype)


def forward(cfg: GraphCastConfig, params, b: MeshBatch, n_mesh: int) -> torch.Tensor:
    """The next state, grid_x + the decoded delta: [n_g, n_vars] in grid_x's
    dtype."""
    return _predict(cfg, params, b, n_mesh, ONE_RANK)


def loss_fn(cfg: GraphCastConfig, params, b: MeshBatch, n_mesh: int) -> torch.Tensor:
    return ((forward(cfg, params, b, n_mesh) - b.target) ** 2).mean()


def make_sharded_loss(cfg: GraphCastConfig, mesh, n_mesh: int, data_axes=("data",)):
    """``loss_fn`` as one rank's program over ``mesh``'s ``data_axes``
    (``None``: one rank): ``b`` holds this rank's n_g/P grid rows and its
    block of the g2m, mesh and m2g edges (global ids); the n_mesh mesh
    latents are split over the ranks too (``_predict``).  The loss, the
    squared error summed over every rank's rows over ``n_g * n_vars``, is
    the same on every rank, and ``torch.autograd.grad`` of it gives each
    rank the whole gradient of the params (``dist.sharded.Replicated``).
    Collective: every rank calls it, forward and backward."""
    ag = ONE_RANK if mesh is None else axis_group(mesh, data_axes)

    def loss(params, b: MeshBatch) -> torch.Tensor:
        pred = _predict(cfg, sharded.replicated(params, ag), b, n_mesh, ag)
        total = sharded.sum_over_ranks(((pred - b.target) ** 2).sum(), ag)
        return total / (b.target.shape[0] * ag.size * b.target.shape[1])

    return loss
