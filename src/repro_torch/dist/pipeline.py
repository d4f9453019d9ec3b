"""GPipe-style pipeline parallelism, the port of ``repro.dist.pipeline``:
one process a rank along a mesh's stage axis (``launch.mesh``).

Each rank owns one stage's params; the input is a stream of M microbatches
(axis 0), the same on every rank.  The schedule is M + S - 1 steps: at step
t stage 0 takes microbatch t, every other stage what the stage before it
handed over at step t - 1, each applies its stage, and the last stage
emits microbatch t - (S - 1) once the fill drains.

The hand-over is one ``all_gather_into_tensor`` a step over the stage
group, of which each rank keeps the previous stage's slot (``_Shift``), on
every backend: gloo's point-to-point ``send``/``recv`` take host tensors
only, and one route keeps the card on the route the CPU tests take.  It
moves S times the bytes of a ring ``send`` (4 MiB a stage a step at
granite-3-2b's width and a microbatch of 1 x 1,024).  ``_Shift`` is an
autograd Function whose backward hands the gradient the other way round
the ring, so the gradient of each stage's params lands on the rank that
owns the stage.  As in JAX's ``shard_map`` every rank runs the same
program: stage 0 selects its input with ``torch.where`` and every stage
its output, so the autograd graph, and the order of the backward's
collectives, is the same on every rank.

The stage fn must be shape-preserving on the microbatch (activation in ==
activation out), which is the standard homogeneous-pipeline contract.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import AxisGroup, axis_group, gather_rows
from repro_torch.tree import tree_map


def _from_neighbour(t: torch.Tensor, ag: AxisGroup, offset: int) -> torch.Tensor:
    """The ``t`` of the rank ``offset`` places round the ring from this one."""
    every = gather_rows(t.unsqueeze(0), ag)
    return every[(ag.index + offset) % ag.size]


class _Shift(torch.autograd.Function):
    """Each stage's output to the next stage round the ring (stage s gets
    stage s - 1's); backward, each gradient back to the stage it came from."""

    @staticmethod
    def forward(ctx, y, ag):
        ctx.ag = ag
        return _from_neighbour(y, ag, -1)

    @staticmethod
    def backward(ctx, grad):
        return _from_neighbour(grad.contiguous(), ctx.ag, 1), None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank (a ``broadcast``, JAX's closing
    ``psum`` of outputs that are zero off the last stage); backward the
    identity, as the adjoint of a replicated output."""

    @staticmethod
    def forward(ctx, out, ag):
        buf = out.detach().clone().contiguous()
        if ag.size > 1:
            dist.broadcast(buf, src=dist.get_global_rank(ag.group, ag.size - 1), group=ag.group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def pipeline_apply(params, x, fn, mesh, stage_axis: str = "stage"):
    """Apply S stages to M microbatches with pipeline parallelism.

    params: this rank's stage's params, every leaf shaped [1, ...] (what
            ``shard_map``'s ``P(stage_axis)`` hands a device).
    x:      [M, ...] microbatch stream (the same on every rank).
    fn:     (stage_params, microbatch) -> microbatch, shape-preserving.

    Returns [M, ...] on every rank: microbatch i pushed through stages
    0..S-1, identical to the sequential reference ``for s in range(S): x =
    fn(params[s], x)``.  Differentiable.  Collective: every rank of the
    stage group calls it.
    """
    ag = axis_group(mesh, (stage_axis,))
    S, s, M = ag.size, ag.index, x.shape[0]
    p_local = tree_map(lambda a: a[0], params)
    first = torch.tensor(s == 0, device=x.device)
    last = torch.tensor(s == S - 1, device=x.device)
    buf = torch.zeros_like(x[0])
    outs = []
    for t in range(M + S - 1):
        # stage 0 injects microbatch t from the stream; later stages
        # consume what the previous stage handed over last step
        y = fn(p_local, torch.where(first, x[min(t, M - 1)], buf))
        if t < M + S - 2:
            buf = _Shift.apply(y, ag)
        if t >= S - 1:   # the last stage emits microbatch t - (S - 1)
            outs.append(torch.where(last, y, torch.zeros_like(y)))
    return _FromLast.apply(torch.stack(outs), ag)
