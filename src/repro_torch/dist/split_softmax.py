"""Split-softmax decode: attention whose keys, or whose query-key
contraction, lie over several ranks, merged with explicit collectives.

The counterpart of what XLA's partitioner derives from JAX's decode step
(``repro.models.transformer._decode_layer``) when the cache is split
(``configs.lm_cells._cache_pspecs``):

  * along its sequence over the data ranks (batch smaller than the data
    ranks): each rank attends over its own block of positions and keeps,
    for each query row, its output and the base-2 log-sum-exp of its
    logits (``local_attention``, or K4 with ``return_lse``); ``combine``
    merges the rows over the group: an all-reduce MAX of the lse, then one
    all-reduce SUM of the weighted outputs beside their weights, in float32,
    ``out = sum_r 2^(lse_r - M) out_r / sum_r 2^(lse_r - M)``.  A rank
    whose block holds no key of the row has ``lse = +inf`` (K4's
    convention) and weight 0;
  * along ``head_dim`` or MLA's ``kv_lora`` over the model ranks: each rank
    holds a slice of every key's width, so its logits are partial sums
    over its slice, summed over the model group (``sum_scores``, an
    all-reduce SUM in float32) before the softmax.

On a group of one rank every function is the one-rank computation and
calls no collective.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import AxisGroup

_LN2 = math.log(2.0)


def sum_scores(partial: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """The logits from each model rank's partial products over its slice of
    the contracted width: float32 ``partial`` summed over ``ag`` (in
    place; one ``all_reduce``)."""
    partial = partial.float().contiguous()
    if ag.size > 1:
        dist.all_reduce(partial, group=ag.group)
    return partial


def local_attention(logits: torch.Tensor, v: torch.Tensor) -> tuple:
    """Softmax attention over one rank's keys, in plain torch.

    logits float32 [..., T] (the rank's keys, all kept; T may be 0), v
    [..., T, Dv] -> (out float32 [..., Dv], lse float32 [...]): the
    probabilities cast to v's dtype before their product with v, as JAX's
    ``_masked_decode_attn`` does, and the rows' base-2 log-sum-exp, ``+inf``
    for a row with no key (whose out is 0)."""
    m = logits.amax(dim=-1, keepdim=True) if logits.shape[-1] else torch.full(
        logits.shape[:-1] + (1,), -math.inf, device=logits.device)
    m0 = torch.where(torch.isinf(m), 0.0, m)
    p = torch.exp(logits - m0)
    l = p.sum(dim=-1, keepdim=True)
    probs = (p / torch.where(l == 0, 1.0, l)).to(v.dtype)
    out = (probs @ v).float()
    lse = torch.where(l == 0, math.inf, (m0 + torch.log(l)) / _LN2)
    return out, lse[..., 0]


def combine(out: torch.Tensor, lse: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Each row's attention over the keys of every rank of ``ag`` from the
    rank's ``out`` [..., Dv] (any float dtype) over its own keys and their
    base-2 ``lse`` float32 [...] (``+inf``: no key here) -> float32 [...,
    Dv], the same on every rank: ``merge`` with ``all_reduce`` over ``ag``.
    A row no rank has a key for gives 0."""
    if ag.size == 1:
        return out.float()
    return merge(out, lse, lambda t, op: dist.all_reduce(t, op=op, group=ag.group))


def merge(out: torch.Tensor, lse: torch.Tensor, all_reduce) -> torch.Tensor:
    """``combine``'s arithmetic, its collective given: ``all_reduce(t, op)``
    reduces float32 ``t`` in place over the ranks by ``op``
    (``torch.distributed.ReduceOp.MAX`` or ``SUM``).  Two reductions: the
    MAX of the lse over the rows that have keys (``+inf`` taken as
    ``-inf``: weight 0, not the max), then the SUM of ``2^(lse - M) out``
    beside ``2^(lse - M)``, whose quotient is returned."""
    out = out.float()
    lse = torch.where(lse == math.inf, -math.inf, lse.float())   # no key: weight 0
    top = lse.clone()
    all_reduce(top, dist.ReduceOp.MAX)
    w = torch.exp2(lse - torch.where(torch.isinf(top), 0.0, top))[..., None]
    acc = torch.cat([out * w, w], dim=-1).contiguous()
    all_reduce(acc, dist.ReduceOp.SUM)
    den = acc[..., -1:]
    return acc[..., :-1] / torch.where(den == 0, 1.0, den)
