"""CellSpec: one (architecture x input-shape x mesh) dry-run unit, the port
of ``repro.configs.cell``, with its mesh helpers: the data axes of a mesh,
its data-parallel size, the ZeRO layout of the optimizer state and the
batch layout.

A cell carries what ``launch.dryrun`` needs to trace one rank's step at
production scale with no allocation: the per-rank step ``fn``, the global
argument specs (trees of ``TensorSpec``, the port's ``ShapeDtypeStruct``)
and their placements (trees of ``launch.mesh.PartitionSpec``, JAX's specs).
JAX lowers the global program and its partitioner splits it; torch has no
partitioner, so ``fn`` is the program of one rank: it takes that rank's
local tensors (``local_specs``, the counterpart of ``shardings_of``) and
runs its own collectives over the mesh's groups.  A mesh is
``launch.mesh``'s (``None``: one rank, where ``fn`` is the single-device
program).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.launch.mesh import P, data_axes_of as _mesh_data_axes, data_parallel_size
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's global shape and dtype, no data (JAX's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * torch.empty((), dtype=self.dtype).element_size()


@dataclasses.dataclass
class CellSpec:
    """``fn(*local args)`` is one rank's step; ``args`` the global specs,
    ``placements`` their ``PartitionSpec`` trees (a ``P`` stands for every
    leaf of the subtree it meets), ``out_placements`` the outputs'.
    ``donate`` names the arguments the step updates in place (JAX's
    ``donate_argnums``).  ``skip`` says why a cell does not apply, naming
    what would lift it."""
    arch: str
    shape: str
    kind: str                      # train | prefill | decode | serve | retrieval | build
    fn: Optional[Callable]
    args: Tuple[Any, ...]          # trees of TensorSpec
    placements: Any
    out_placements: Any = None
    donate: Tuple[int, ...] = ()
    skip: Optional[str] = None
    meta: dict = dataclasses.field(default_factory=dict)


def specs_of(tree) -> Any:
    """The ``TensorSpec`` tree of a tree of tensors (``jax.eval_shape``'s
    result, from tensors made on ``meta``); other leaves stay as they are."""
    return tree_map(lambda x: TensorSpec(tuple(x.shape), x.dtype)
                    if isinstance(x, torch.Tensor) else x, tree)


def map_specs(fn: Callable, specs: Any, pspecs: Any) -> Any:
    """``fn(spec, pspec)`` over the ``TensorSpec`` leaves of ``specs`` and
    the matching ``PartitionSpec`` of ``pspecs``, a tree of the same shape
    or a prefix of it (a ``P`` covers its whole subtree)."""
    if specs is None:
        return None
    if isinstance(specs, TensorSpec):
        if not isinstance(pspecs, P):
            raise ValueError(f"{specs} has no PartitionSpec (got {pspecs!r})")
        return fn(specs, pspecs)
    pspecs_of = (lambda _: pspecs) if isinstance(pspecs, P) else (lambda k: pspecs[k])
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, pspecs_of(k)) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, v, pspecs_of(i)) for i, v in enumerate(specs)))
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(fn, v, pspecs_of(i)) for i, v in enumerate(specs))
    return specs   # a leaf that is no tensor (a Python number)


class UnevenShard(ValueError):
    """A placement whose axes do not divide the dimension they split."""


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(tuple(mesh.mesh_dim_names).index(axis))


def local_shape(mesh, shape: Tuple[int, ...], pspec: P) -> Tuple[int, ...]:
    """One rank's block of a tensor of global ``shape`` placed by ``pspec``
    on ``mesh`` (``None``: one rank, the whole).  An axis whose extent does
    not divide its dimension raises ``UnevenShard`` (a ``ValueError``), as
    JAX's lowering does."""
    if len(pspec) > len(shape):
        raise ValueError(f"{pspec!r} has more entries than the shape {shape} has dims")
    out = list(shape)
    for i, entry in enumerate(pspec):
        if entry is None or mesh is None:
            continue
        k = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            k *= _axis_size(mesh, a)
        if out[i] % k:
            raise UnevenShard(f"dimension {i} of {tuple(shape)} ({out[i]}) does not split "
                             f"over {entry!r} ({k} ranks)")
        out[i] //= k
    return tuple(out)


def local_specs(mesh, specs: Any, pspecs: Any) -> Any:
    """The ``TensorSpec`` tree of one rank's blocks (the counterpart of
    ``shardings_of``: where JAX gives each argument a sharding, the port
    gives each rank its block's shape)."""
    return map_specs(lambda s, p: TensorSpec(local_shape(mesh, s.shape, p), s.dtype),
                     specs, pspecs)


def meta_tensors(specs: Any) -> Any:
    """Tensors on ``meta`` of a ``TensorSpec`` tree: what a dry run feeds
    a cell's ``fn``, allocating nothing."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")
                    if isinstance(x, TensorSpec) else x, specs)


def spec_bytes(tree: Any) -> int:
    """The bytes of every ``TensorSpec`` leaf of ``tree``."""
    return sum(x.nbytes for x in tree_leaves(tree) if isinstance(x, TensorSpec))


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


def model_size(mesh) -> int:
    """The ranks of ``mesh``'s model axis (1 without one, or without a mesh)."""
    from repro_torch.launch.mesh import MODEL_AXIS

    if mesh is None or MODEL_AXIS not in mesh.mesh_dim_names:
        return 1
    return _axis_size(mesh, MODEL_AXIS)


def host_step(opt_state):
    """The optimizer's step counter as a host number's tensor: the port
    computes the learning rate on the host, and a dry run's ``meta`` step
    has no value, so it starts from step 0."""
    if opt_state.step.device.type == "meta":
        return opt_state._replace(step=torch.zeros((), dtype=torch.int32))
    return opt_state


def batch_pspec(mesh, extra_dims: int = 1) -> P:
    """Shard the leading (batch) dim over all DP axes."""
    axes = data_axes_of(mesh)
    lead = axes if len(axes) > 1 else axes[0]
    return P(lead, *([None] * extra_dims))
