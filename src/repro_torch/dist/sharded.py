"""The autograd Functions of the per-rank programs: one rank's share of a
loss whose tensors are split over the ranks of an axis group
(``launch.mesh.AxisGroup``), each collective of the forward paired with its
adjoint in the backward.

The counterpart of what JAX's partitioner derives from one global program.
Every per-rank loss of the port imports them from here: GCN's
``make_sharded_loss``, GatedGCN's ``make_dstlocal_loss`` and
``make_sharded_loss``, SchNet's and GraphCast's ``make_sharded_loss``, and
xDeepFM's forward over a table split over ``"model"``.

In the backward a tensor that a rank owns alone (its node rows, its edges'
messages, its partial sums) carries the whole gradient of its elements; a
tensor held whole on every rank (the replicated params) carries a partial,
which the ranks' gradients sum to:

  * ``Gather``: the ranks' row blocks [n/P, ...] -> the whole [n, ...]
    (``gather_rows``), optionally over a narrower wire dtype; adjoint: the
    gradient summed over the ranks (bfloat16's in float32), each keeping
    its own rows (``scatter_sum_rows``).
  * ``ScatterSum``: an [n, ...] partial summed over the ranks, each keeping
    its own rows (``scatter_sum_rows``); adjoint: the rows' gradients
    gathered (``gather_rows``).
  * ``Replicated``: params held whole on every rank, the identity; adjoint:
    their partial gradients summed over the ranks, one ``all_reduce`` of
    them all flattened (in float32 for bfloat16 params), so each rank gets
    the whole gradient of the global loss.
  * ``SumOver``: a tensor summed over the ranks (``all_reduce``); adjoint:
    the identity.  Right only where every rank holds the same downstream
    gradient of the sum, the whole of it: a loss computed alike on every
    rank from the sum (the global loss, xDeepFM's model-axis gather).

The losses call ``gather`` and ``scatter_sum`` through this module at each
call, so that a check can put a wrong exchange in their place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.launch.mesh import AxisGroup, gather_rows, scatter_sum_rows, sum_over
from repro_torch.tree import tree_flatten, tree_unflatten

_NARROW = (torch.bfloat16, torch.float16)


class Gather(torch.autograd.Function):
    """This rank's rows [n/P, ...] -> the whole [n, ...] in h's dtype, over
    ``wire`` (``None``: h's dtype); see the module's docstring.  The
    backward sums bfloat16 and float16 gradients in float32, the others in
    their own dtype."""

    @staticmethod
    def forward(ctx, h, ag, wire):
        ctx.ag = ag
        x = h if wire is None else h.to(wire)
        x = gather_rows(x, ag) if ag.size > 1 else x
        return x.to(h.dtype) if x is not h else h.view_as(h)

    @staticmethod
    def backward(ctx, grad):
        if ctx.ag.size == 1:
            return grad, None, None
        wide = grad.float() if grad.dtype in _NARROW else grad
        return scatter_sum_rows(wide, ctx.ag).to(grad.dtype), None, None


class ScatterSum(torch.autograd.Function):
    """An [n, ...] partial -> its sum over the ranks, this rank's rows."""

    @staticmethod
    def forward(ctx, partial, ag):
        ctx.ag = ag
        if ag.size == 1:
            return partial.view_as(partial)
        return scatter_sum_rows(partial.contiguous(), ag)

    @staticmethod
    def backward(ctx, grad):
        return (gather_rows(grad.contiguous(), ctx.ag) if ctx.ag.size > 1 else grad), None


class Replicated(torch.autograd.Function):
    """The params, whole on every rank: the identity; backward their
    gradients summed over the ranks (JAX's adjoint of a replicated input)."""

    @staticmethod
    def forward(ctx, ag, *params):
        ctx.ag = ag
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        wide = [g.reshape(-1).float() if g.dtype in _NARROW else g.reshape(-1) for g in grads]
        flat = sum_over(torch.cat(wide), ctx.ag)
        return (None, *(x.view_as(g).to(g.dtype)
                        for x, g in zip(flat.split([g.numel() for g in grads]), grads)))


class SumOver(torch.autograd.Function):
    """A tensor summed over the ranks; backward the identity (see the
    module's docstring for where that is right)."""

    @staticmethod
    def forward(ctx, x, ag):
        return sum_over(x, ag)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gather(h: torch.Tensor, ag: AxisGroup, wire: Optional[torch.dtype] = None) -> torch.Tensor:
    """``Gather``: every rank's rows of ``h``, the whole stream."""
    return Gather.apply(h, ag, wire)


def scatter_sum(partial: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """``ScatterSum``: this rank's rows of ``partial`` summed over the ranks."""
    return ScatterSum.apply(partial, ag)


def replicated(params, ag: AxisGroup):
    """``params`` (a tree) through ``Replicated``; themselves on one rank."""
    if ag.size == 1:
        return params
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, list(Replicated.apply(ag, *leaves)))


def sum_over_ranks(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """``SumOver``: ``x`` summed over the ranks, the same on every rank."""
    return SumOver.apply(x, ag) if ag.size > 1 else x
