"""Wrappers of the port's hand-written CUDA kernels.

A wrapper checks device, dtype, shape and contiguity, then:

  * for CUDA tensors it launches its kernel on the current stream, checks the
    launch's ``cudaGetLastError()`` code and raises on a failure;
  * for CPU tensors it runs the kernel's plain version (``ref``).

There is no fall-back from the kernel to the plain version: which one runs
depends only on where the tensors lie.  ``LAUNCHES`` counts kernel launches
per kernel (the plain version is not counted), so a run can show that its
serving path and its device build really went through the kernels.

``tier_intersect`` (K1) serves queries and ``frontier_or`` (K2) expands the
device wave build.  ``bitset_mm`` (K3), ``flash_attention`` (K4: two
kernels, chosen by dtype in ``attention_kernel``), ``ell_spmm`` (K5) and
``embedding_bag`` (K6) are the kernel library, the counterpart of
``repro.kernels.ops``: no oracle path calls them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"label_intersect": 0, "frontier_or": 0, "bitset_mm": 0,
            "flash_attention": 0, "flash_attention_sm90": 0, "ell_spmm": 0,
            "embedding_bag": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_matrix(name: str, t: torch.Tensor, dtype=torch.int32) -> None:
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    if t.shape[1] < 1:
        raise ValueError(f"{name} must have at least one column, got {tuple(t.shape)}")


def _device(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one device every tensor lies on: cpu (the plain version runs) or
    cuda (the kernel launches)."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return dev


def _launch(name: str, dev: torch.device, *args) -> None:
    """Launch kernel ``name`` on the current stream of ``dev`` (building it on
    first use), raise on a nonzero launch code, count the launch."""
    from repro_torch.kernels.build import library

    launch = library(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


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
    dev = _device("label_intersect", L_out, L_in, queries)
    if dev.type == "cpu":
        return ref.tier_intersect_ref(L_out, L_in, queries, width)
    B = queries.shape[0]
    out = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return out
    n, Lo = L_out.shape
    Li = L_in.shape[1]
    _launch("label_intersect", dev, L_out.data_ptr(), L_in.data_ptr(), n, Lo, Li,
            queries.data_ptr(), B, min(width, Lo), min(width, Li), out.data_ptr())
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
    dev = _device("frontier_or", nbr, *tensors)
    if dev.type == "cpu":
        return ref.frontier_or_ref(nbr, f, out, perm, flags)
    r, d = nbr.shape
    n_src, wm = f.shape
    if not fused:
        out = torch.empty((r, wm), dtype=torch.int32, device=dev)
        flags = torch.zeros(2, dtype=torch.int32, device=dev)
    if r == 0:
        return out
    _launch("frontier_or", dev, nbr.data_ptr(), r, d, f.data_ptr(), n_src, wm,
            out.data_ptr(), out.shape[0], perm.data_ptr() if fused else None,
            flags.data_ptr())
    if not fused and int(flags[1]):
        raise ValueError(f"frontier_or: neighbor ids outside [-1, {n_src})")
    return out


# ----------------------------------------------------------- kernel library


def bitset_mm(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K3: the OR-AND boolean product of bit-packed operands,
    ``out[i] = OR over j < k with bit j of a[i] set of x[j]`` (one
    transitive-closure step is ``R | bitset_mm(R, R)``).

    a: int32[n, ceil(k/32)], x: int32[k, wm] (int32 bit patterns; bit j of
    word w is column 32w + j) -> int32[n, wm].  Bits of ``a`` at or beyond
    ``k`` are ignored."""
    _check_matrix("a", a)
    _check_matrix("x", x)
    k, wm = x.shape
    if a.shape[1] != (k + 31) // 32:
        raise ValueError(f"a has {a.shape[1]} words per row, k = {k} needs {(k + 31) // 32}")
    dev = _device("bitset_mm", a, x)
    if dev.type == "cpu":
        return ref.bitset_mm_ref(a, x)
    n = a.shape[0]
    out = torch.empty((n, wm), dtype=torch.int32, device=dev)
    if n:
        _launch("bitset_mm", dev, a.data_ptr(), n, a.shape[1], x.data_ptr(), k, wm,
                out.data_ptr())
    return out


def ell_spmm(nbr: torch.Tensor, wgt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K5: the weighted ELL SpMM,
    ``out[i] = sum over s with nbr[i, s] != -1 of wgt[i, s] * x[nbr[i, s]]``,
    accumulated in float32 in slot order.

    nbr: int32[n, d], wgt: float32[n, d], x: float32[n_src, F] ->
    float32[n, F].  Only -1 is padding: any other id outside [0, n_src)
    raises ``ValueError`` (the kernel skips and flags it; the wrapper reads
    the flag, one host read per call)."""
    _check_matrix("nbr", nbr)
    _check_matrix("wgt", wgt, torch.float32)
    _check_matrix("x", x, torch.float32)
    if wgt.shape != nbr.shape:
        raise ValueError(f"wgt {tuple(wgt.shape)} must match nbr {tuple(nbr.shape)}")
    dev = _device("ell_spmm", nbr, wgt, x)
    if dev.type == "cpu":
        return ref.ell_spmm_ref(nbr, wgt, x)
    (n, d), (n_src, F) = nbr.shape, x.shape
    out = torch.empty((n, F), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch("ell_spmm", dev, nbr.data_ptr(), wgt.data_ptr(), n, d, x.data_ptr(), n_src, F,
            out.data_ptr(), flags.data_ptr())
    if int(flags[0]):
        raise ValueError(f"ell_spmm: neighbor ids outside [-1, {n_src})")
    return out


def embedding_bag(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K6: the sum of each bag's rows,
    ``out[b] = sum over s with idx[b, s] >= 0 of table[idx[b, s]]``,
    accumulated in float32 in slot order.

    table: float32[V, D], idx: int32[B, bag] -> float32[B, D].  Every
    negative id is padding; an id >= V raises ``ValueError`` (the kernel
    skips and flags it; the wrapper reads the flag, one host read per
    call)."""
    _check_matrix("table", table, torch.float32)
    _check_matrix("idx", idx)
    dev = _device("embedding_bag", table, idx)
    if dev.type == "cpu":
        return ref.embedding_bag_ref(table, idx)
    (V, D), (B, bag) = table.shape, idx.shape
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch("embedding_bag", dev, table.data_ptr(), V, D, idx.data_ptr(), B, bag,
            out.data_ptr(), flags.data_ptr())
    if int(flags[0]):
        raise ValueError(f"embedding_bag: ids >= V = {V}")
    return out


# K4's kernel for each input dtype: bfloat16 on the tensor cores (wgmma),
# float32 on the CUDA cores (the tensor cores would run it as TF32)
ATTENTION_KERNELS = {torch.bfloat16: "flash_attention_sm90", torch.float32: "flash_attention"}


def attention_kernel(dtype: torch.dtype) -> str:
    """The kernel ``flash_attention`` launches for inputs of ``dtype``: a
    dispatch by dtype alone, never a fall-back from one kernel to the other."""
    try:
        return ATTENTION_KERNELS[dtype]
    except KeyError:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not {dtype}") from None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None, scale=None) -> torch.Tensor:
    """K4: softmax attention with causal, sliding-window and GQA masks, the
    semantics of ``repro.kernels.ops.flash_attention``.

    q: [B, Hq, S, D], k and v: [B, Hkv, T, D], all float32 or all bfloat16,
    contiguous -> q's dtype [B, Hq, S, D].  q head h reads kv head
    ``h // (Hq // Hkv)``.  Query positions are right-aligned to the keys
    (``qpos = s + T - S``); ``causal`` keeps keys ``t <= qpos``; ``window``
    (None or an int) keeps ``t > qpos - window``, also without ``causal``.
    A row that keeps no key gives 0.  ``scale`` defaults to ``1/sqrt(D)``
    (taken in float32).  Needs Hq a multiple of Hkv, ``D % 8 == 0`` with
    ``8 <= D <= 128``, S, T >= 1, and q, k and v 16-byte aligned (on either
    device, so both take the same inputs).  Logits, the softmax and the
    output accumulate in float32.

    On the card, bfloat16 runs ``csrc/flash_attention_sm90.cu`` (both
    products on the tensor cores, counted as ``flash_attention_sm90``) and
    float32 ``csrc/flash_attention.cu`` (the CUDA cores, counted as
    ``flash_attention``); ``attention_kernel`` picks by dtype."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dim() != 4 or not t.is_contiguous()
                or t.dtype not in (torch.float32, torch.bfloat16)):
            raise ValueError(f"{name} must be a contiguous 4-D float32 or bfloat16 tensor, "
                             f"got {t.dtype} {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[{B}, Hkv, T, {D}]")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq = {Hq} must be a multiple of Hkv = {Hkv}")
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f"head dim D = {D} must be a multiple of 8 in [8, 128]")
    if S < 1 or T < 1:
        raise ValueError(f"S = {S} and T = {T} must be at least 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            # the sm90 kernel reads q, k and v 16 bytes at a time (k and v by
            # TMA, which needs a 16-byte aligned base), the float32 kernel k
            # and v; a misaligned read would fault and end the CUDA context
            # instead of raising here
            raise ValueError(f"{name} must start at a 16-byte aligned address, got "
                             f"{t.data_ptr() % 16} bytes past one")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    dev = _device("flash_attention", q, k, v)
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if B > 65535 or Hkv > 65535:
        raise ValueError(f"B = {B} and Hkv = {Hkv} must be at most 65,535 (grid size)")
    kernel = attention_kernel(q.dtype)
    out = torch.empty_like(q)   # aligned: the sm90 kernel writes 16 bytes at a time
    if B:
        _launch(kernel, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Hq, Hkv, S, T, D, int(bool(causal)), window is not None,
                0 if window is None else int(window), scale)
    return out
