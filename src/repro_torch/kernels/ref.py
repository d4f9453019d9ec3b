"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, in torch ops.  The kernel
wrappers in ``ops`` run these for tensors on the CPU; on the card, the tests
and ``chip_smoke.py`` hold each kernel against its plain version on the same
inputs.  The serve engine's ``dense`` backend is ``tier_intersect_ref`` on
the engine's device; its ``kernel`` backend, the main path on a card, never
calls them there.  ``frontier_or_ref`` is K2's, the device wave build's
expansion when the build runs on the CPU.
"""
from __future__ import annotations

import torch

INVALID = -1


def label_intersect_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: int32[B, La], b: int32[B, Lb] (INVALID padded) -> bool[B]:
    row-wise non-empty intersection over valid entries (the counterpart of
    ``repro.kernels.ref.label_intersect_ref``)."""
    eq = a[:, :, None] == b[:, None, :]
    valid = (a[:, :, None] != INVALID) & (b[:, None, :] != INVALID)
    return (eq & valid).flatten(1).any(dim=1)


def tier_intersect_ref(L_out: torch.Tensor, L_in: torch.Tensor,
                       queries: torch.Tensor, width: int) -> torch.Tensor:
    """Gather the queried rows, truncate each side to ``width`` and intersect.

    L_out: int32[n, Lo], L_in: int32[n, Li], queries: int32[B, 2] -> bool[B].
    ``[:, :width]`` clamps each side on its own when ``width`` exceeds the
    matrix, exactly as ``repro.serve.engine._tier_intersect`` does."""
    q = queries.long()
    a = L_out.index_select(0, q[:, 0])[:, :width]
    b = L_in.index_select(0, q[:, 1])[:, :width]
    return label_intersect_ref(a, b)


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR over ``dim`` (torch has no OR reduction): halves folded
    together until one slice is left.  An empty ``dim`` gives zeros."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        head = x[:h] | x[h:2 * h]
        x = torch.cat([head, x[2 * h:]]) if x.shape[0] % 2 else head
    return x[0]


def frontier_or_ref(nbr: torch.Tensor, f: torch.Tensor, out=None, perm=None,
                    flags=None) -> torch.Tensor:
    """K2's plain version: ``acc[i] = OR over s with nbr[i, s] != INVALID of
    f[nbr[i, s]]`` (the counterpart of ``repro.kernels.ref``'s numpy loop and
    of ``engine_jax._expand_fn._slab_xla``).

    nbr: int32[r, d] ELL slab, f: int32[n_src, wm] packed member words (int32
    bit patterns).  With ``out`` None it returns ``acc`` as int32[r, wm] and
    raises ``ValueError`` on an id outside [-1, n_src).  With ``out`` given
    (int32[n_out, wm], ``perm`` int64[r], ``flags`` int32[2]) it ORs ``acc[i]``
    into ``out[perm[i]]`` in place, sets ``flags[0] = 1`` when a word of
    ``out`` gained a bit and ``flags[1] = 1`` when an id outside [-1, n_src)
    (or a ``perm`` entry outside [0, n_out)) was met and skipped, and returns
    ``out``; the caller reads ``flags``."""
    n_src = f.shape[0]
    ids = nbr.long()
    bad_id = (ids < INVALID) | (ids >= n_src)
    if out is None and bool(bad_id.any()):
        raise ValueError(f"frontier_or: neighbor ids outside [-1, {n_src})")
    ok = (ids != INVALID) & ~bad_id
    rows = f[torch.where(ok, ids, 0)]                        # [r, d, wm]
    acc = or_reduce(torch.where(ok[:, :, None], rows, 0), dim=1)
    if out is None:
        return acc
    dst = perm.long()
    bad_dst = (dst < 0) | (dst >= out.shape[0])
    dst, acc = dst[~bad_dst], acc[~bad_dst]
    old = out[dst]
    # flags stay on the tensors' device: no host read here
    flags[0] |= (acc & ~old).ne(0).any().to(torch.int32)
    flags[1] |= (bad_id.any() | bad_dst.any()).to(torch.int32)
    out[dst] = old | acc
    return out
