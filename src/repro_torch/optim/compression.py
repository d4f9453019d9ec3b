"""Gradient compression for the data-parallel all-reduce, the port of
``repro.optim.compression``.

Each rank quantizes every gradient leaf to int8 with a float32 scale a
block of 256 values (the block's largest magnitude over 127), the ranks
sum the codes exactly in int32 and average the scales, and each rank
dequantizes the summed codes with the mean scale and divides by the ranks:
JAX's formula to the bit.  The mean scale is JAX's approximation: the
result is off the true mean by as much as the ranks' scales differ (the
summed codes of rank r carry rank r's scale, not the mean).  A
stochastic-rounding variant draws uniform noise in [-0.5, 0.5) before
rounding, which keeps each rank's codes unbiased.

Wire format: one ``all_gather_into_tensor`` of the int8 codes and one of
the float32 scales, summed on each rank in int32 in the group's order.
Every rank's 1 + 4/256 bytes an element reach every other rank: in a ring
a rank sends (P - 1) x 1.016 bytes an element, where JAX's int32 ``psum``
in a ring all-reduce sends 2 (P - 1) / P x 4 (3.05 against 6 at P = 4;
fewer up to P = 7).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.launch.mesh import axis_group, gather_rows
from repro_torch.tree import tree_flatten, tree_unflatten


def _quantize_int8(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                   block: int = 256):
    """x float32[...] -> (q int8[blocks, block], scale float32[blocks, 1])
    with a per-block absmax scale, rounded half to even (``jnp.round``),
    clipped to +-127; with ``generator``, uniform noise in [-0.5, 0.5)
    drawn from it is added before rounding."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.view(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / _number(127.0, blocks)
    scale = torch.where(scale == 0, 1.0, scale)
    scaled = blocks / scale
    if generator is not None:
        scaled = scaled + (torch.rand(scaled.shape, generator=generator,
                                      device=scaled.device) - 0.5)
    return torch.round(scaled).clamp_(-127, 127).to(torch.int8), scale


def _number(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor on ``like``'s device: dividing by it is true
    division, where the card's kernel divides by a Python number through its
    reciprocal, one rounding off JAX's formula."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """Codes [blocks, block] (any integer type) times their scales, the
    padding dropped, in ``shape``."""
    size = 1
    for s in shape:
        size *= s
    return (q.to(torch.float32) * scale).reshape(-1)[:size].reshape(shape)


def quantized_psum_grads(grads, mesh, axes: Sequence[str] = ("data",),
                         generator: Optional[torch.Generator] = None, block: int = 256):
    """The mean of ``grads`` (a tree of tensors, the same shapes on every
    rank) over the ranks of ``mesh``'s ``axes``, through int8 codes (see the
    module docstring): a tree of float32 tensors, the same on every rank.
    Collective: every rank of the group calls it with the same tree."""
    ag = axis_group(mesh, axes)
    n = ag.size
    leaves, treedef = tree_flatten(grads)
    out = []
    for g in leaves:
        q, scale = _quantize_int8(g.to(torch.float32), generator, block)
        qs = gather_rows(q, ag).view(n, *q.shape)
        ss = gather_rows(scale, ag).view(n, *scale.shape)
        q_sum = qs[0].to(torch.int32)
        scale_sum = ss[0].clone()
        for r in range(1, n):
            q_sum += qs[r]
            scale_sum += ss[r]
        n_t = _number(n, q_sum)
        out.append(_dequantize_int8(q_sum, scale_sum / n_t, g.shape) / n_t)
    return tree_unflatten(treedef, out)
