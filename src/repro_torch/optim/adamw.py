"""AdamW with a float32 master copy over (possibly bfloat16) params,
global-norm clipping and a warmup + cosine schedule: the port of
``repro.optim.adamw``, over the port's trees of tensors (``repro_torch.tree``).

The update is the JAX package's, with one difference in how, not what: it
writes the first and second moments, the master copy and the params in
place, one leaf at a time, so a step holds no second copy of the optimizer
state (granite-3-2b's is 30 GB) and at most one leaf's float32 temporaries.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


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
    g_leaves = tree_leaves(grads)
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    step = int(state.step) + 1
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    lr = float(lr)
    for p, g, m, v, w in zip(tree_leaves(params), g_leaves, tree_leaves(state.mu),
                             tree_leaves(state.nu), tree_leaves(state.master)):
        g32 = g.float() * scale
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        del g32
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        w.sub_(upd.add_(w, alpha=weight_decay), alpha=lr)
        del upd
        p.copy_(w)
    new_state = AdamWState(step=torch.full_like(state.step, step), mu=state.mu, nu=state.nu,
                           master=state.master)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
