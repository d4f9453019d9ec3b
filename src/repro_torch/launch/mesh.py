"""Device meshes and the two collectives of the multi-device modes.

The counterpart of ``repro.launch.mesh``.  JAX runs a mesh from one
controller; the port runs one process a rank (``torch.distributed``), and
every rank runs the same program on the same inputs.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with JAX's axis names
(``"data"``, ``"model"``, and ``"pod"`` on a multi-pod mesh).  Local shards
are plain tensors and every exchange is an explicit collective that both
gloo (on CPU and CUDA tensors) and NCCL take:

  * an OR of bool or uint8 results is an ``all_reduce`` ``MAX``
    (``or_over``): NCCL has no bitwise-OR reduction;
  * a gather of row blocks that each rank owns alone is an
    ``all_gather_into_tensor`` (``gather_rows``), bool travelling as uint8;
  * a sum over the ranks is an ``all_reduce`` ``SUM`` (``sum_over``), and
    the sum of row blocks that lands each block on the rank that owns it a
    ``reduce_scatter_tensor`` (``scatter_sum_rows``): training's exchanges.

``PartitionSpec`` (``P``) is JAX's placement of a tensor on a mesh, one
entry a dimension: ``None``, an axis name or a tuple of axis names.  The
port keeps it as data (``models.transformer.param_pspecs``,
``configs.cell.zero_pspecs``); it places nothing by itself.

The meshes are made by FUNCTIONS, never at import: importing this module
touches no process group.  ``form_mesh`` (the counterpart of
``jax.make_mesh``) lays a mesh of a given shape over an initialised process
group.  The groups ``DeviceMesh`` makes for its axes take the backend's
default timeout (30 min under gloo, 10 under NCCL): a mesh sets another
only through backend-specific process-group options, which change from one
torch release to the next.  So ``form_mesh`` and ``make_production_mesh``
make, on every rank at once, the two groups the multi-device modes run
their collectives in, each with ``timeout``: the data axes (every axis but
``"model"``) and the model axis.  A rank left waiting in a collective by a
rank that failed raises after it (gloo) or is ended by the watchdog (NCCL)
instead of hanging.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import weakref
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# how long a rank waits in a collective of a mesh's axis groups
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks that share this rank's coordinates off ``axes``: their
    process group, how many they are and this rank's place among them
    (row-major over ``axes``)."""
    axes: tuple
    group: object
    size: int
    index: int


MODEL_AXIS = "model"

# the group of a run without a mesh: one rank, no process group
ONE_RANK = AxisGroup((), None, 1, 0)


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: a tuple with one entry a dimension (``None``,
    an axis name, or a tuple of axis names sharing that dimension)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# id(mesh) -> {axes: AxisGroup}, dropped with the mesh.  Keyed by identity:
# two meshes of one shape compare equal, and a dict keyed by the mesh would
# keep the first one's key, dropping the second one's groups with the first
_GROUPS: dict = {}


def _register(mesh, timeout: datetime.timedelta):
    """Make the process groups of ``mesh``'s data axes and of its model
    axis (where it has one).  Collective: every rank of the mesh calls it,
    in the same order."""
    names = tuple(mesh.mesh_dim_names)
    ranks = mesh.mesh.cpu()
    entry = {}
    data = tuple(a for a in names if a != MODEL_AXIS)
    for axes in (data, (MODEL_AXIS,) if MODEL_AXIS in names else ()):
        if not axes:
            continue
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        # one row per group: the other axes' coordinates fixed, ``axes``
        # varying row-major (ascending ranks, so a rank's place in its row
        # is its rank in the group, the order of ``all_gather_into_tensor``)
        table = ranks.permute(*rest, *dims).reshape(-1, math.prod(ranks.shape[d] for d in dims))
        group, _ = dist.new_subgroups_by_enumeration(table.tolist(), timeout=timeout)
        entry[axes] = AxisGroup(axes, group, table.shape[1], dist.get_rank(group))
    _GROUPS[id(mesh)] = entry
    weakref.finalize(mesh, _GROUPS.pop, id(mesh), None)
    return mesh


def form_mesh(shape: Sequence[int], axis_names: Sequence[str], device_type: Optional[str] = None,
              timeout: datetime.timedelta = TIMEOUT):
    """A ``DeviceMesh`` of ``shape`` with ``axis_names`` over the initialised
    default process group, its ranks laid out row-major: the counterpart of
    ``jax.make_mesh(shape, axis_names)``.  Collective: every rank calls it.

    ``device_type`` is the mesh's device type (DTensor's; the collectives
    here run wherever their tensors lie): ``"cuda"`` under NCCL, else
    ``"cpu"`` by default.  Raises ``RuntimeError`` without a process group
    and ``ValueError`` when the shape does not cover the world."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("form_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"shape {shape} and axis names {axis_names} do not match")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axis_names)
    return _register(mesh, timeout)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 cards per pod; 2 pods = 512 cards multi-pod, with JAX's
    shapes and axis names (``init_device_mesh`` on CUDA).  Collective."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _register(init_device_mesh("cuda", shape, mesh_dim_names=axes), TIMEOUT)


def data_axes_of(mesh) -> tuple:
    """The DP axes for this mesh ('pod' folds into DP when present)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def data_parallel_size(mesh) -> int:
    n = 1
    for a in data_axes_of(mesh):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _groups(mesh) -> dict:
    entry = _GROUPS.get(id(mesh)) if getattr(mesh, "mesh_dim_names", None) else None
    if entry is None:
        raise ValueError(f"{mesh!r} is not a mesh made by form_mesh or make_production_mesh")
    return entry


def axes_except(mesh, axis: str = "model") -> tuple:
    """Every axis of ``mesh`` but ``axis``, in the mesh's order: the data
    axes of JAX's engine (by default) and of its ``mesh=`` build."""
    _groups(mesh)
    return tuple(ax for ax in mesh.mesh_dim_names if ax != axis)


def axis_group(mesh, axes: Sequence[str]) -> AxisGroup:
    """This rank's group over ``axes`` of a mesh made by ``form_mesh`` or
    ``make_production_mesh``: its data axes or its model axis.
    ``ValueError`` for another mesh, an axis the mesh lacks or another set
    of axes."""
    entry = _groups(mesh)
    axes, names = tuple(axes), tuple(mesh.mesh_dim_names)
    if not axes or any(a not in names for a in axes):
        raise ValueError(f"axes {axes} are not axes of the mesh {names}")
    # the groups are keyed by the mesh's axis order
    key = tuple(a for a in names if a in axes)
    if key not in entry:
        raise ValueError(f"the mesh has groups for {sorted(entry)} only, not for {key}")
    return entry[key]


def or_over(t: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """The OR of a bool or uint8 tensor over the ranks of ``ag``: an
    ``all_reduce`` MAX of its uint8 copy (NCCL has no bitwise OR)."""
    if t.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"or_over takes bool or uint8, got {t.dtype}")
    buf = t.to(torch.uint8, copy=True).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=ag.group)
    return buf.bool() if t.dtype == torch.bool else buf


def gather_rows(part: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Every rank's ``part`` (the same shape on each, at least 1-D) stacked
    in the group's order along dim 0, by ``all_gather_into_tensor``.  Bool
    parts travel as uint8."""
    wire = part.to(torch.uint8) if part.dtype == torch.bool else part
    buf = torch.empty((ag.size * part.shape[0],) + tuple(part.shape[1:]), dtype=wire.dtype,
                      device=part.device)
    dist.all_gather_into_tensor(buf, wire.contiguous(), group=ag.group)
    return buf.bool() if part.dtype == torch.bool else buf


def sum_over(t: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``ag`` (an ``all_reduce`` SUM of
    a copy); ``t`` itself for a group of one."""
    if ag.size == 1:
        return t
    buf = t.detach().clone().contiguous()
    dist.all_reduce(buf, group=ag.group)
    return buf


def scatter_sum_rows(full: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """The sum over the ranks of ``ag`` of ``full`` ([size * rows, ...] on
    every rank), of which this rank keeps its own block of ``rows`` (the
    group's order, as ``gather_rows`` lays blocks out): a
    ``reduce_scatter_tensor``."""
    if ag.size == 1:
        return full
    out = torch.empty((full.shape[0] // ag.size,) + tuple(full.shape[1:]), dtype=full.dtype,
                      device=full.device)
    dist.reduce_scatter_tensor(out, full.contiguous(), group=ag.group)
    return out
