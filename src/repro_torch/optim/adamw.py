"""AdamW with a float32 master copy over (possibly bfloat16) params,
global-norm clipping and a warmup + cosine schedule: the port of
``repro.optim.adamw``, over the port's trees of tensors (``repro_torch.tree``).

The update is the JAX package's, with one difference in how, not what: it
writes the first and second moments, the master copy and the params in
place, one leaf at a time, so a step holds no second copy of the optimizer
state (granite-3-2b's is 30 GB) and at most one leaf's float32 temporaries.

ZeRO (``zero_init``, ``ZeroLayout.mean_part``, ``zero_update``): the
counterpart of the optimizer state the JAX package's LM cells shard by
``configs.cell.zero_pspecs``.  Each rank of a data group keeps only its
slice of ``master``, ``mu`` and ``nu`` along each leaf's ZeRO dimension (a
leaf that nothing divides stays whole on every rank, as JAX falls back),
receives only that slice of the averaged gradient (a
``reduce_scatter_tensor``; an ``all_reduce`` for a whole leaf), clips by
the norm of the whole gradient (the slices' squares summed over the
ranks, so every rank takes the same scale; a leaf split over ``"model"``
as well, as xDeepFM's tables, has its squares summed over the model ranks
too), updates its slice and all-gathers the params, rounded to their
dtype.  ``zero_gather`` and ``zero_shard`` move between that state and the
whole one that checkpoints keep (the JAX package's layout).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.launch.mesh import (MODEL_AXIS, ONE_RANK, AxisGroup, axis_group, data_axes_of,
                                    gather_rows, scatter_sum_rows, sum_over)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar: the updates taken
    mu: Any              # float32 first moment (same tree as params)
    nu: Any              # float32 second moment
    master: Any          # float32 master copy of params


def adamw_init(params) -> AdamWState:
    """Zero moments and a float32 copy of ``params``, on the params' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
    )


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> float:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine decay
    to ``min_frac * base_lr`` at ``total``."""
    step = int(step)
    if step < warmup:
        return base_lr * (step + 1) / max(warmup, 1)
    progress = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * progress)))


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``tree``."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32) for x in tree_leaves(tree)]
    return torch.stack(norms).square().sum().sqrt()


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (new_params, new_state, metrics), as the JAX package's: the
    gradients clipped to ``clip_norm`` by their global norm, bias-corrected
    moments, decoupled weight decay on the float32 master, the params the
    master cast to their dtypes.  ``params`` and ``state``'s moments and
    master are updated in place and returned."""
    gnorm = global_norm(grads)
    step, leaf = _prepare(gnorm, state, lr, b1, b2, eps, weight_decay, clip_norm)
    for p, g, m, v, w in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
                             tree_leaves(state.nu), tree_leaves(state.master)):
        leaf(g, m, v, w)
        p.copy_(w)
    return params, _advanced(state, step), {"grad_norm": gnorm, "lr": float(lr)}


def _prepare(gnorm, state: AdamWState, lr, b1, b2, eps, weight_decay, clip_norm):
    """The new step and the in-place update of one leaf's moments and
    master from its gradient, clipped by the global norm ``gnorm``."""
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    step = int(state.step) + 1
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    lr = float(lr)

    def leaf(g, m, v, w):
        g32 = g.float() * scale
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        del g32
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        w.sub_(upd.add_(w, alpha=weight_decay), alpha=lr)

    return step, leaf


def _advanced(state: AdamWState, step: int) -> AdamWState:
    return AdamWState(step=torch.full_like(state.step, step), mu=state.mu, nu=state.nu,
                      master=state.master)


# ---------------------------------------------------------------------------
# ZeRO: the optimizer state sharded over a data group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ZeroLayout:
    """Where each param leaf's optimizer state lives: ``dims[i]`` is the
    dimension of leaf i (``tree_leaves`` order) that ``group``'s ranks split
    evenly, in the group's order, or ``None`` for a leaf whole on every
    rank of ``group``.  ``over_model[i]``: leaf i is a block of a param
    split over ``model`` (the ranks of the mesh's model axis, when they
    are more than one), whose gradient norm sums over them too."""
    dims: Tuple[Optional[int], ...]
    group: AxisGroup
    over_model: Tuple[bool, ...]
    model: AxisGroup = ONE_RANK

    def part(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of leaf ``i``'s whole tensor ``x`` (a view)."""
        d = self.dims[i]
        if d is None:
            return x
        n = x.shape[d] // self.group.size
        return x.narrow(d, self.group.index * n, n)

    def mean_part(self, acc: torch.Tensor, i: int, denom: int) -> torch.Tensor:
        """This rank's slice of leaf ``i``'s ``acc`` summed over the ranks and
        divided by ``denom``: a ``reduce_scatter_tensor`` along its dimension
        (an ``all_reduce`` of the whole for a leaf without one).  The sums
        are the same bits on every rank.  Collective."""
        d = self.dims[i]
        if d is None:
            return sum_over(acc, self.group) / denom
        return scatter_sum_rows(acc.movedim(d, 0).contiguous(), self.group).movedim(0, d) / denom

    def whole(self, part: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i``'s whole tensor from every rank's ``part``: an
        ``all_gather_into_tensor`` over the group along its dimension.
        Collective."""
        d = self.dims[i]
        if d is None or self.group.size == 1:
            return part
        return gather_rows(part.movedim(d, 0).contiguous(), self.group).movedim(0, d)


def _spec_leaves(specs) -> list:
    """The ``PartitionSpec`` leaves of a tree of dicts and lists, in
    ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for x in specs for s in _spec_leaves(x)]
    return [specs]


def _names_axis(entry, axis: str) -> bool:
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def zero_layout(opt_pspecs, mesh) -> ZeroLayout:
    """The layout of ``configs.cell.zero_pspecs``' tree over ``mesh``'s data
    group (``None``: one rank, every leaf whole), the leaves whose spec
    names ``"model"`` split over a model axis of more than one rank."""
    specs = _spec_leaves(opt_pspecs)
    if mesh is None:
        return ZeroLayout(tuple(None for _ in specs), ONE_RANK, tuple(False for _ in specs))
    axes = data_axes_of(mesh)
    lead = axes if len(axes) > 1 else axes[0]
    dims = tuple(next((i for i, e in enumerate(spec) if e == lead), None) for spec in specs)
    model = ONE_RANK
    if MODEL_AXIS in mesh.mesh_dim_names:
        model = axis_group(mesh, (MODEL_AXIS,))
    over = tuple(model.size > 1 and any(_names_axis(e, MODEL_AXIS) for e in spec)
                 for spec in specs)
    return ZeroLayout(dims, axis_group(mesh, axes), over, model)


def zero_init(params, layout: ZeroLayout) -> AdamWState:
    """``adamw_init`` of this rank's slices: zero moments and a float32 copy
    of each param's slice."""
    leaves, treedef = tree_flatten(params)
    parts = [layout.part(p.detach(), i) for i, p in enumerate(leaves)]
    zeros = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in parts]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        mu=tree_unflatten(treedef, zeros),
        nu=tree_unflatten(treedef, [torch.zeros_like(z) for z in zeros]),
        master=tree_unflatten(treedef, [x.to(torch.float32, copy=True) for x in parts]),
    )


@torch.no_grad()
def zero_update(grad_parts, state: AdamWState, params, lr, layout: ZeroLayout,
                b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.1, clip_norm: float = 1.0):
    """``adamw_update`` over ZeRO-sharded state: ``grad_parts`` (a list in
    ``tree_leaves`` order) holds this rank's slice of each leaf's averaged
    gradient (``ZeroLayout.mean_part``; the whole for a leaf without a
    dimension), ``state`` this rank's slices (``zero_init``).  The clip takes
    the whole gradient's norm: the slices' squares summed over the ranks,
    the whole leaves' once; a leaf split over the model ranks
    (``over_model``) has its squares summed over them as well, the others
    count once.  Each rank updates its slices; ``params`` are all-gathered
    in place.  Collective."""
    zero = torch.zeros((), dtype=torch.float32, device=grad_parts[0].device)

    def squares(model_split: bool) -> torch.Tensor:
        sharded = [g for g, d, o in zip(grad_parts, layout.dims, layout.over_model)
                   if d is not None and o == model_split]
        whole = [g for g, d, o in zip(grad_parts, layout.dims, layout.over_model)
                 if d is None and o == model_split]
        sq = sum_over(global_norm(sharded).square(), layout.group) if sharded else zero
        return sq + global_norm(whole).square() if whole else sq

    sq = squares(False)
    if any(layout.over_model):
        sq = sq + sum_over(squares(True), layout.model)
    gnorm = sq.sqrt()
    step, leaf = _prepare(gnorm, state, lr, b1, b2, eps, weight_decay, clip_norm)
    for i, (p, g, m, v, w) in enumerate(zip(tree_leaves(params), grad_parts,
                                            tree_leaves(state.mu), tree_leaves(state.nu),
                                            tree_leaves(state.master))):
        leaf(g, m, v, w)
        p.copy_(layout.whole(w.to(p.dtype), i))
    return params, _advanced(state, step), {"grad_norm": gnorm, "lr": float(lr)}


@torch.no_grad()
def zero_gather(state: AdamWState, layout: ZeroLayout) -> AdamWState:
    """The whole state from every rank's slices (what a checkpoint saves,
    the JAX package's layout).  Collective."""
    def whole(tree):
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [layout.whole(x, i) for i, x in enumerate(leaves)])

    return AdamWState(step=state.step, mu=whole(state.mu), nu=whole(state.nu),
                      master=whole(state.master))


def zero_shard(state: AdamWState, layout: ZeroLayout) -> AdamWState:
    """This rank's slices of a whole state (a restored checkpoint's)."""
    def part(tree):
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [layout.part(x, i).clone() for i, x in enumerate(leaves)])

    return AdamWState(step=state.step, mu=part(state.mu), nu=part(state.nu),
                      master=part(state.master))
