"""Wrappers of the port's hand-written CUDA kernels.

A wrapper checks device, dtype, shape and contiguity, then:

  * for CUDA tensors it launches its kernel on the current stream, checks the
    launch's ``cudaGetLastError()`` code and raises on a failure;
  * for CPU tensors it runs the kernel's plain version (``ref``).

There is no fall-back from the kernel to the plain version: which one runs
depends only on where the tensors lie.  ``LAUNCHES`` counts kernel launches
per kernel (the plain version is not counted), so a run can show that its
serving path really went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"label_intersect": 0}


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

