"""Wrappers of the port's hand-written CUDA kernels.

A wrapper checks device, dtype, shape and contiguity, then:

  * for CUDA tensors it launches its kernel on the current stream, checks the
    launch's ``cudaGetLastError()`` code and raises on a failure;
  * for CPU tensors it runs the kernel's plain version (``ref``).

There is no fall-back from the kernel to the plain version: which one runs
depends only on where the tensors lie.  ``LAUNCHES`` counts kernel launches
per kernel (the plain version is not counted), so a run can show that its
serving path and its device build really went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"label_intersect": 0, "frontier_or": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_matrix(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D int32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    if t.shape[1] < 1:
        raise ValueError(f"{name} must have at least one column, got {tuple(t.shape)}")


def tier_intersect(L_out: torch.Tensor, L_in: torch.Tensor,
                   queries: torch.Tensor, width: int) -> torch.Tensor:
    """K1, fused: bool[B], entry i true iff ``L_out[q[i,0], :wa]`` and
    ``L_in[q[i,1], :wb]`` share a valid value, with ``wa = min(width, Lo)``
    and ``wb = min(width, Li)``.

    L_out: int32[n, Lo], L_in: int32[n, Li] (resident, INVALID padded),
    queries: int32[B, 2] with ids in [0, n).  The kernel answers false for an
    id outside that range without reading memory; the plain version raises.
    """
    _check_matrix("L_out", L_out)
    _check_matrix("L_in", L_in)
    _check_matrix("queries", queries)
    if queries.shape[1] != 2:
        raise ValueError(f"queries must be int32[B, 2], got {tuple(queries.shape)}")
    if L_out.shape[0] != L_in.shape[0]:
        raise ValueError(f"L_out and L_in disagree on n: {L_out.shape[0]} vs {L_in.shape[0]}")
    width = int(width)
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    dev = L_out.device
    if L_in.device != dev or queries.device != dev:
        raise ValueError(f"tensors on different devices: {dev}, {L_in.device}, "
                         f"{queries.device}")
    if dev.type == "cpu":
        return ref.tier_intersect_ref(L_out, L_in, queries, width)
    if dev.type != "cuda":
        raise ValueError(f"label_intersect runs on cuda or cpu, not {dev}")
    B = queries.shape[0]
    out = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return out
    from repro_torch.kernels.build import library

    launch = library("label_intersect")
    n, Lo = L_out.shape
    Li = L_in.shape[1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(L_out.data_ptr(), L_in.data_ptr(), n, Lo, Li,
                    queries.data_ptr(), B, min(width, Lo), min(width, Li),
                    out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"label_intersect launch failed: CUDA error {rc}")
    LAUNCHES["label_intersect"] += 1
    return out



def frontier_or(nbr: torch.Tensor, f: torch.Tensor, out=None, perm=None,
                flags=None) -> torch.Tensor:
    """K2: one BFS level of every wave member over one ELL slab,
    ``acc[i] = OR over s with nbr[i, s] != INVALID of f[nbr[i, s]]``.

    nbr: int32[r, d] INVALID-padded neighbor ids, f: int32[n_src, wm] packed
    member words (int32 bit patterns; the kernel reads them as uint32).

    * ``out`` None: returns ``acc`` as a new int32[r, wm]; an id outside
      [-1, n_src) raises ``ValueError`` (the kernel skips it and flags it,
      and the wrapper reads the flag: one host read per call).
    * ``out`` int32[n_out, wm] with ``perm`` int64[r] (distinct rows of
      ``out``) and ``flags`` int32[2]: the device build's fused form, with
      no host read.  ORs ``acc[i]`` into ``out[perm[i]]`` in place, sets
      ``flags[0] = 1`` when a word of ``out`` gained a bit and ``flags[1] = 1``
      when an id outside [-1, n_src) or a ``perm`` entry outside [0, n_out)
      was met (and skipped).  The caller reads ``flags`` and must raise on
      ``flags[1]``.  ``f`` must not share memory with ``out``.
    """
    _check_matrix("nbr", nbr)
    if f.dtype != torch.int32 or f.dim() != 2 or not f.is_contiguous():
        raise ValueError(f"f must be a contiguous 2-D int32 tensor, got "
                         f"{f.dtype} {tuple(f.shape)} contiguous={f.is_contiguous()}")
    dev = nbr.device
    fused = out is not None
    if fused:
        _check_matrix("out", out)
        if out.shape[1] != f.shape[1]:
            raise ValueError(f"out has {out.shape[1]} words per row, f has {f.shape[1]}")
        if (perm is None or perm.dtype != torch.int64 or perm.dim() != 1
                or not perm.is_contiguous() or perm.shape[0] != nbr.shape[0]):
            raise ValueError("the fused form needs perm as a contiguous int64[r]")
        if (flags is None or flags.dtype != torch.int32 or flags.shape != (2,)
                or not flags.is_contiguous()):
            raise ValueError("the fused form needs flags as a contiguous int32[2]")
        if out.data_ptr() == f.data_ptr():
            raise ValueError("f must not share memory with out")
        tensors = (f, out, perm, flags)
    else:
        if perm is not None or flags is not None:
            raise ValueError("perm and flags belong to the fused form (out given)")
        tensors = (f,)
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in (nbr, *tensors)]}")
    if dev.type == "cpu":
        return ref.frontier_or_ref(nbr, f, out, perm, flags)
    if dev.type != "cuda":
        raise ValueError(f"frontier_or runs on cuda or cpu, not {dev}")
    r, d = nbr.shape
    n_src, wm = f.shape
    if not fused:
        out = torch.empty((r, wm), dtype=torch.int32, device=dev)
        flags = torch.zeros(2, dtype=torch.int32, device=dev)
    if r == 0:
        return out
    from repro_torch.kernels.build import library

    launch = library("frontier_or")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(nbr.data_ptr(), r, d, f.data_ptr(), n_src, wm,
                    out.data_ptr(), out.shape[0],
                    perm.data_ptr() if fused else None, flags.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"frontier_or launch failed: CUDA error {rc}")
    LAUNCHES["frontier_or"] += 1
    if not fused and int(flags[1]):
        raise ValueError(f"frontier_or: neighbor ids outside [-1, {n_src})")
    return out
