"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, in torch ops.  The kernel
wrappers in ``ops`` run these for tensors on the CPU; on the card, the tests
and ``chip_smoke.py`` hold each kernel against its plain version on the same
inputs.  The serve engine's ``dense`` backend is ``tier_intersect_ref`` on
the engine's device; its ``kernel`` backend, the main path on a card, never
calls them there.
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
