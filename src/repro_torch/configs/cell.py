"""The mesh helpers of ``repro.configs.cell``: the data axes of a mesh, its
data-parallel size, the ZeRO layout of the optimizer state and the batch
layout.  A mesh is ``launch.mesh``'s (``None``: one rank); a layout is a
tree of ``launch.mesh.PartitionSpec``.  ``CellSpec`` and the lowering
helpers (``shardings_of``, ``spec_bytes``) belong to the dry run, which is
not ported yet (ROADMAP.md Queue 1, item 12.5).
"""
from __future__ import annotations

from typing import Any

from repro_torch.launch.mesh import P, data_axes_of as _mesh_data_axes, data_parallel_size


def data_axes_of(mesh) -> tuple:
    """The DP axes of ``mesh`` ('pod' folds into DP when present);
    ``("data",)`` without a mesh."""
    return ("data",) if mesh is None else _mesh_data_axes(mesh)


def dp_size(mesh) -> int:
    return 1 if mesh is None else data_parallel_size(mesh)


def zero_pspecs(shape_tree: Any, pspec_tree: Any, mesh) -> Any:
    """ZeRO sharding for optimizer state: take each param's pspec and
    additionally shard the first free, divisible dimension over the DP axes.
    Falls back to the param spec when nothing divides.  ``shape_tree``: the
    params (dicts and lists of tensors or shapes), ``pspec_tree`` the same
    tree of ``PartitionSpec``.  A dimension the spec gives to an axis counts
    as taken whatever the axis's extent."""
    axes = data_axes_of(mesh)
    dp = dp_size(mesh)
    lead = axes if len(axes) > 1 else axes[0]

    def one(shape, spec):
        dims = tuple(getattr(shape, "shape", shape))
        entries = list(spec) + [None] * (len(dims) - len(spec))
        for i, (d, s) in enumerate(zip(dims, entries)):
            if s is None and d > 0 and d % dp == 0:
                entries[i] = lead
                return P(*entries)
        return P(*entries)

    def walk(shapes, specs):
        if isinstance(specs, P):
            return one(shapes, specs)
        if isinstance(specs, dict):
            return {k: walk(shapes[k], specs[k]) for k in specs}
        return [walk(a, b) for a, b in zip(shapes, specs)]

    return walk(shape_tree, pspec_tree)


def batch_pspec(mesh, extra_dims: int = 1) -> P:
    """Shard the leading (batch) dim over all DP axes."""
    axes = data_axes_of(mesh)
    lead = axes if len(axes) > 1 else axes[0]
    return P(lead, *([None] * extra_dims))
