"""Megatron tensor parallelism over a mesh's model axis: the collectives of
one rank's program when each rank of ``"model"`` holds a block of each
weight (``models.transformer.param_pspecs``).

The counterpart of what XLA's partitioner derives from ``param_pspecs``.
The residual stream is whole on every model rank; a column-split product
reads it through ``copy_to_model`` and a row-split product leaves it
through ``reduce_from_model``:

  * ``copy_to_model`` (Megatron's *f*): the identity; backward the
    gradient summed over the model ranks (``all_reduce``), each having
    formed only its own columns' part of it.
  * ``reduce_from_model`` (*g*): the partials summed over the model ranks
    (``all_reduce``); backward the identity, every rank holding the whole
    gradient of the stream.
  * ``gather_from_model``: the ranks' blocks of a dimension (the last by
    default) all-gathered (``dist.sharded.Gather`` along it); adjoint a
    reduce-scatter, the ranks' gradients of the whole summed, each keeping
    its own block.  Right where each rank reads its own part of the whole
    (a kv head that spans several ranks' columns; in a decode over a cache
    split along ``head_dim`` or ``kv_lora``, the new key row, every head's
    query, and the heads' outputs from every rank's slice of their width).
  * ``vocab_parallel_embed``: a rank's block of the vocabulary's rows; ids
    outside it give 0, then ``reduce_from_model``.
  * ``vocab_parallel_log_softmax_gather``: log p(label) over logits split
    by vocabulary: the max and the sum of exponentials each all-reduced,
    the label's logit taken from the rank that owns it; backward
    ``onehot - softmax`` over the rank's block.

Every collective moves the tensor in its own dtype (gloo and NCCL take
bfloat16), as XLA's partitioned program does.  On ``ONE_RANK`` every
function is the identity (or the one-rank computation) and calls no
collective, so the one-rank path is the same code.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import sharded
from repro_torch.launch.mesh import MODEL_AXIS, ONE_RANK, AxisGroup, axis_group, sum_over


def model_group(mesh) -> AxisGroup:
    """The ranks of ``mesh``'s model axis (one rank without a mesh or
    without the axis)."""
    if mesh is None or MODEL_AXIS not in mesh.mesh_dim_names:
        return ONE_RANK
    return axis_group(mesh, (MODEL_AXIS,))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag):
        ctx.ag = ag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return sum_over(grad, ctx.ag), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag):
        return sum_over(x, ag)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """*f*: ``x``; its gradient summed over the model ranks."""
    return x if ag.size == 1 else _CopyToModel.apply(x, ag)


def reduce_from_model(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """*g*: ``x`` summed over the model ranks; its gradient passed on."""
    return x if ag.size == 1 else _ReduceFromModel.apply(x, ag)


def gather_from_model(x: torch.Tensor, ag: AxisGroup, dim: int = -1) -> torch.Tensor:
    """Every model rank's ``x`` [..., c] laid side by side along dimension
    ``dim`` (the last by default), [..., ag.size * c] in the group's order;
    the adjoint sums the ranks' gradients and keeps this rank's block."""
    if ag.size == 1:
        return x
    return sharded.Gather.apply(x.movedim(dim, 0).contiguous(), ag, None).movedim(0, dim)


def vocab_parallel_embed(embed: torch.Tensor, tokens: torch.Tensor,
                         ag: AxisGroup) -> torch.Tensor:
    """The rows of ``tokens`` (int[...]) in a table split by vocabulary:
    ``embed`` is this rank's block [V / size, d] of rows ``ag.index * V /
    size`` on."""
    tokens = tokens.long()
    if ag.size == 1:
        return embed[tokens]
    local = tokens - ag.index * embed.shape[0]
    inside = (local >= 0) & (local < embed.shape[0])
    rows = embed[local.clamp(0, embed.shape[0] - 1)]
    return reduce_from_model(torch.where(inside[..., None], rows, torch.zeros_like(rows)), ag)


class _VocabLogSoftmaxGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, ag):
        V = logits.shape[-1]
        local = labels - ag.index * V
        inside = (local >= 0) & (local < V)
        local = local.clamp(0, V - 1)
        m = logits.detach().amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=ag.group)
        ex = torch.exp(logits - m[..., None])
        se = sum_over(ex.sum(dim=-1), ag)
        picked = (logits.gather(-1, local[..., None])[..., 0] - m) * inside
        target = sum_over(picked, ag)
        ex /= se[..., None]
        ctx.save_for_backward(ex, local, inside)
        return target - torch.log(se)

    @staticmethod
    def backward(ctx, grad):
        soft, local, inside = ctx.saved_tensors
        g = -soft * grad[..., None]
        g.scatter_add_(-1, local[..., None], (grad * inside)[..., None].to(g.dtype))
        return g, None, None


def vocab_parallel_log_softmax_gather(logits: torch.Tensor, labels: torch.Tensor,
                                      ag: AxisGroup) -> torch.Tensor:
    """log softmax(logits)[label] over the whole vocabulary, [...], the same
    on every model rank: ``logits`` float32[..., V / size] is this rank's
    block of the vocabulary (``ag.index * V / size`` on), ``labels``
    int[...] in [0, V)."""
    labels = labels.long()
    if ag.size == 1:
        return torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
    return _VocabLogSoftmaxGather.apply(logits, labels, ag)
