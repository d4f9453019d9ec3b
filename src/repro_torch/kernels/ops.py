"""Wrappers of the port's hand-written CUDA kernels.

A wrapper checks device, dtype, shape and contiguity, then:

  * for CUDA tensors it launches its kernel on the current stream, checks the
    launch's ``cudaGetLastError()`` code and raises on a failure;
  * for CPU tensors it runs the kernel's plain version (``ref``);
  * for ``meta`` tensors (a dry run's trace, ``launch.dryrun``) it returns
    outputs of the kernel's shapes and dtypes, adds the kernel's operations
    and bytes (the bound formulas of PERF.md §6, for every entry the inputs
    allow: a dry run has no data) to ``META_COST``, and neither launches
    nor runs the plain version.

There is no fall-back from the kernel to the plain version: which one runs
depends only on where the tensors lie.  ``LAUNCHES`` counts kernel launches
per kernel (the plain version is not counted), so a run can show that its
serving path and its device build really went through the kernels.

``ServeBatch`` (K1's batch form) serves each batch of the engine's
``kernel`` backend in one launch and ``frontier_expand`` (K2's frontier
form) runs each BFS level of the device wave build.  ``tier_intersect``
(K1's tier form, the counterpart of ``repro.kernels.ops.label_intersect``
and the JAX engine's ``_tier_intersect``), ``frontier_or`` (K2's slab
form), ``bitset_mm`` (K3), ``flash_attention``
(K4: two kernels, chosen by dtype in ``attention_kernel``), ``ell_spmm``
(K5) and ``embedding_bag`` (K6) are the counterparts of
``repro.kernels.ops``.  The substrate's models call K4 (every attention of
the LM family, decode over its preallocated cache through ``kv_len``), K5
(GCN's aggregation) and K6 (xDeepFM's two gathers); K3 has no caller.

K4, K5 and K6 are ``torch.autograd.Function``s, so training differentiates
through the kernels: K4's backward is ``flash_attention_bwd`` (two kernels,
chosen by dtype in ``attention_bwd_kernel``: bfloat16
``csrc/flash_attention_bwd_sm90.cu``, float32 ``csrc/flash_attention_bwd.cu``,
each reading the log-sum-exp K4's forward keeps for it),
K5's is K5 itself over the transposed rows, K6's is ``embedding_bag_bwd``
(``csrc/embedding_bag_bwd.cu``).  A backward, like a forward, launches its
kernel for CUDA tensors and runs its plain version for CPU tensors; its
launches count under its own name (``flash_attention_bwd``, and the bfloat16
kernel's also under ``flash_attention_bwd_sm90``; ``ell_spmm_bwd``,
``embedding_bag_bwd``).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from repro_torch.kernels import ref

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"serve_batch": 0, "label_intersect": 0, "frontier_expand": 0, "frontier_or": 0,
            "bitset_mm": 0, "flash_attention": 0, "flash_attention_sm90": 0, "ell_spmm": 0,
            "embedding_bag": 0, "flash_attention_bwd": 0, "flash_attention_bwd_sm90": 0,
            "ell_spmm_bwd": 0, "embedding_bag_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# kernel name -> {"calls", "flops", "bytes"} of its calls on meta tensors since
# the last reset_meta_cost(): what a dry run's trace would have the card do
META_COST: dict = {}


def reset_meta_cost() -> None:
    META_COST.clear()


def _meta_cost(name: str, flops: int, nbytes: int) -> None:
    """Add one meta call of kernel ``name`` doing ``flops`` operations over
    ``nbytes`` bytes (each input read once, each output written once)."""
    c = META_COST.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
    c["calls"] += 1
    c["flops"] += int(flops)
    c["bytes"] += int(nbytes)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _check_matrix(name: str, t: torch.Tensor, dtype=torch.int32) -> None:
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    if t.shape[1] < 1:
        raise ValueError(f"{name} must have at least one column, got {tuple(t.shape)}")


def _device(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one device every tensor lies on: cpu (the plain version runs),
    cuda (the kernel launches) or meta (a dry run: shapes and costs only)."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name} runs on cuda, cpu or meta, not {dev}")
    return dev


def _launch(name: str, dev: torch.device, *args, stream=None, count=None) -> None:
    """Launch kernel ``name`` on ``stream`` (default: the current stream of
    ``dev``), building it on first use; raise on a nonzero launch code, count
    the launch under ``count`` (default ``name``)."""
    from repro_torch.kernels.build import library

    launch = library(name)
    if stream is None:
        stream = torch.cuda.current_stream(dev)
    if torch.cuda.current_device() == dev.index:   # the common case: no device switch
        rc = launch(*args, stream.cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = launch(*args, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[count or name] += 1


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
    if dev.type == "meta":
        # every query's two truncated rows read whole, a compare per pair
        wa, wb = min(width, L_out.shape[1]), min(width, L_in.shape[1])
        _meta_cost("label_intersect", B * wa * wb, B * (8 + 4 * (wa + wb) + 1))
        return out
    if B == 0:
        return out
    n, Lo = L_out.shape
    Li = L_in.shape[1]
    _launch("label_intersect", dev, L_out.data_ptr(), L_in.data_ptr(), n, Lo, Li,
            queries.data_ptr(), B, min(width, Lo), min(width, Li), out.data_ptr())
    return out


# the kernel takes the tier widths as launch parameters: at most this many
SERVE_BATCH_MAX_TIERS = 16
# bit 7 of a serve_batch code: a false verdict the truncated labels cannot prove
SERVE_BATCH_UNCERTAIN = ref.SERVE_BATCH_UNCERTAIN
# the flag word leads the codes in the output buffers (kCodesAt in the source)
_FLAG_BYTES = 16
# rows a construction-time layout check reads at once
_CHECK_ROWS = 1 << 20


class ServeBatch:
    """K1's batch form bound to one engine's resident state: one call serves
    a whole batch of condensation-id queries, ``codes = sb(queries)``, in one
    copy in, one launch (``csrc/serve_batch.cu``) and one copy out.

    L_out int32[n, Lo], L_in int32[n, Li] (INVALID after each row's length,
    checked here), out_len / in_len int32[n], level None or int32[n], widths
    the engine's ascending tier widths.  The resident state is checked once,
    here; a call checks only its queries.  ``ref.serve_batch_ref`` defines
    the codes: ``2 * fate + verdict``, fate 0 for a prefiltered query and
    1 + t for one intersected in tier t.  Under a memory budget
    ``trunc_out`` / ``trunc_in`` (both or neither) are the store's packed
    truncation masks, uint8[ceil(n / 8)] in ``np.packbits`` order
    (``TruncatedStore.packed_masks``), and ``SERVE_BATCH_UNCERTAIN`` (bit 7)
    marks the false verdicts they leave unproven.  ``unread_out`` /
    ``unread_in`` (bool[n] or None) name rows no call reads, which the
    layout check skips: the engine's quarantined rows, zero-filled by a
    non-strict snapshot load, whose queries it sends to exact search.

    On CUDA tensors a call stages the queries in a pinned host buffer and
    makes one foreign call, which issues on the current stream, without
    blocking, the copy of the ids to a device buffer, the launch and one copy
    back of the kernel's bad-id flag and the codes; then it synchronises once
    on that stream.  The buffers grow by powers of two.  A lock serialises
    calls, which share the buffers.  On CPU tensors it runs
    ``ref.serve_batch_ref``.  An id outside [-n, n) raises ``IndexError``
    (the kernel flags it and reads nothing)."""

    def __init__(self, L_out, L_in, out_len, in_len, level, widths, trunc_out=None,
                 trunc_in=None, unread_out=None, unread_in=None):
        _check_matrix("L_out", L_out)
        _check_matrix("L_in", L_in)
        n = L_out.shape[0]
        if L_in.shape[0] != n:
            raise ValueError(f"L_out and L_in disagree on n: {n} vs {L_in.shape[0]}")
        if n >= 2**31:
            raise ValueError(f"n = {n} does not fit int32 ids")
        _check_vector("out_len", out_len, torch.int32, n)
        _check_vector("in_len", in_len, torch.int32, n)
        if level is not None:
            _check_vector("level", level, torch.int32, n)
        widths = [int(w) for w in widths]
        if not 1 <= len(widths) <= SERVE_BATCH_MAX_TIERS or widths[0] < 1 or \
                any(b <= a for a, b in zip(widths, widths[1:])):
            raise ValueError(f"widths must be 1 to {SERVE_BATCH_MAX_TIERS} ascending "
                             f"positive ints, got {widths}")
        if (trunc_out is None) != (trunc_in is None):
            raise ValueError("trunc_out and trunc_in are both given or both None")
        masks = () if trunc_out is None else (trunc_out, trunc_in)
        for name, m in zip(("trunc_out", "trunc_in"), masks):
            _check_vector(name, m, torch.uint8, (n + 7) // 8)
        self.dev = _device("serve_batch", L_out, L_in, out_len, in_len,
                           *(() if level is None else (level,)), *masks)
        # the kernel compares a row up to its length: nothing valid may lie past
        # it in a row that a call reads
        for name, L, lens, unread in (("L_out", L_out, out_len, unread_out),
                                      ("L_in", L_in, in_len, unread_in)):
            if self.dev.type == "meta":   # no entries to check
                break
            if unread is None:
                unread = torch.zeros(n, dtype=torch.bool, device=self.dev)
            else:
                _check_vector(f"unread_{name[2:]}", unread, torch.bool, n)
            if bool((((lens < 0) | (lens > L.shape[1])) & ~unread).any()):
                raise ValueError(f"{name} lengths outside [0, {L.shape[1]}]")
            cols = torch.arange(L.shape[1], device=self.dev)[None, :]
            for i in range(0, n, _CHECK_ROWS):
                rows = slice(i, i + _CHECK_ROWS)
                past = (cols >= lens[rows, None]) & (L[rows] != ref.INVALID)
                if bool((past & ~unread[rows, None]).any()):
                    raise ValueError(f"{name} holds a label entry at or after its row's length")
        self.L_out, self.L_in, self.out_len, self.in_len, self.level = \
            L_out, L_in, out_len, in_len, level
        self.trunc_out, self.trunc_in = trunc_out, trunc_in
        self.widths = widths
        self._widths_c = (ctypes.c_int32 * len(widths))(*widths)   # read at each launch
        # the launch's leading arguments, the same every call
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        self._bound_args = (
            L_out.data_ptr(), L_in.data_ptr(), n, L_out.shape[1], L_in.shape[1],
            out_len.data_ptr(), in_len.data_ptr(), ptr(level), ptr(trunc_out), ptr(trunc_in),
            ctypes.addressof(self._widths_c), len(widths))
        self._lock = threading.Lock()
        self._cap = 0

    def _grow(self, B: int) -> None:
        cap = 1 << max(B - 1, 0).bit_length()
        self._h_q = torch.empty((cap, 2), dtype=torch.int32, pin_memory=True)
        self._d_q = torch.empty((cap, 2), dtype=torch.int32, device=self.dev)
        self._h_out = torch.zeros(_FLAG_BYTES + cap, dtype=torch.uint8, pin_memory=True)
        self._d_out = torch.zeros(_FLAG_BYTES + cap, dtype=torch.uint8, device=self.dev)
        self._h_q_np, self._h_out_np = self._h_q.numpy(), self._h_out.numpy()
        self._cap = cap

    def __call__(self, queries: np.ndarray) -> np.ndarray:
        """uint8[B] codes of int32[B, 2] host queries (condensation ids).  On
        meta state: a meta uint8[B] tensor (there are no codes to copy back)."""
        if not (isinstance(queries, np.ndarray) and queries.dtype == np.int32
                and queries.ndim == 2 and queries.shape[1] == 2):
            raise ValueError("queries must be a numpy int32[B, 2] array, got "
                             f"{getattr(queries, 'dtype', type(queries))} "
                             f"{getattr(queries, 'shape', '')}")
        if self.dev.type == "meta":
            # a query's ids in, its two lengths (and levels) and two rows at
            # full width read, a code out; a compare per pair of entries
            B = queries.shape[0]
            Lo, Li = self.L_out.shape[1], self.L_in.shape[1]
            per = 8 + 8 + (8 if self.level is not None else 0) + 4 * (Lo + Li) + 1
            _meta_cost("serve_batch", B * Lo * Li, B * per)
            return torch.empty(B, dtype=torch.uint8, device="meta")
        if self.dev.type == "cpu":
            return ref.serve_batch_ref(self.L_out, self.L_in, self.out_len, self.in_len,
                                       self.level, self.widths, torch.from_numpy(queries),
                                       self.trunc_out, self.trunc_in).numpy()
        B = queries.shape[0]
        if B == 0:
            return np.zeros(0, dtype=np.uint8)
        stream = torch.cuda.current_stream(self.dev)
        with self._lock:
            if B > self._cap:
                self._grow(B)
            self._h_q_np[:B] = queries
            _launch("serve_batch", self.dev, *self._bound_args, self._h_q.data_ptr(),
                    self._d_q.data_ptr(), B, self._h_out.data_ptr(), self._d_out.data_ptr(),
                    stream=stream)
            stream.synchronize()
            if self._h_out_np[:4].view(np.int32)[0]:
                self._d_out[:4].zero_()
                n = self.L_out.shape[0]
                raise IndexError(f"query ids outside [-{n}, {n})")
            return self._h_out_np[_FLAG_BYTES:_FLAG_BYTES + B].copy()


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
    if dev.type == "meta":
        # the ids, every slot's frontier words and the out rows read, the out
        # rows written; an OR per gathered word
        _meta_cost("frontier_or", r * d * wm,
                   r * d * 4 + r * d * wm * 4 + (r * 8 + 2 * r * wm * 4 if fused else r * wm * 4))
        return out if fused else torch.empty((r, wm), dtype=torch.int32, device=dev)
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


# the kernel stages a row's pushed words in shared memory: 8 warps x wm words
FRONTIER_EXPAND_MAX_WORDS = 1024


def _check_vector(name: str, t: torch.Tensor, dtype, size=None) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() or \
            (size is not None and t.shape[0] != size):
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor"
                         + (f" of {size}" if size is not None else "")
                         + f", got {t.dtype} {tuple(t.shape)}")


class FrontierExpand:
    """K2's frontier form bound to one build's state: the tensors that stay
    the same from level to level are checked once, here, and each call
    checks only what changes (the ring slice, the two delta matrices, the
    target label matrix and the ids) before it launches.  The device build
    makes one call per BFS level; ``frontier_expand`` is one call of a
    fresh binding.

    frontier int32[cap] (a ring), indptr int64[n + 1], indices int32[m],
    v / pruned int32[n, wm] (bit patterns), hop_mask int32[n_hop, wm],
    stamps int32[3, n], cone int32[n], counts int64[3] (ring position, cone
    length, bad-id flag)."""

    def __init__(self, frontier, indptr, indices, v, pruned, hop_mask, stamps, cone, counts):
        _check_matrix("v", v)
        n, wm = v.shape
        for name, t in (("pruned", pruned), ("hop_mask", hop_mask)):
            _check_matrix(name, t)
            if t.shape[1] != wm or (name == "pruned" and t.shape[0] != n):
                raise ValueError(f"{name} is {tuple(t.shape)}, v is {tuple(v.shape)}")
        if wm > FRONTIER_EXPAND_MAX_WORDS:
            raise ValueError(f"wm = {wm} words exceeds {FRONTIER_EXPAND_MAX_WORDS}")
        _check_matrix("stamps", stamps)
        if stamps.shape != (3, n):
            raise ValueError(f"stamps must be int32[3, {n}], got {tuple(stamps.shape)}")
        _check_vector("frontier", frontier, torch.int32)
        _check_vector("indptr", indptr, torch.int64, n + 1)
        _check_vector("indices", indices, torch.int32)
        _check_vector("cone", cone, torch.int32, n)
        _check_vector("counts", counts, torch.int64, 3)
        self.dev = _device("frontier_expand", frontier, indptr, indices, v, pruned, hop_mask,
                           stamps, cone, counts)
        self.n, self.wm = n, wm
        self.frontier, self.indptr, self.indices, self.v, self.pruned = \
            frontier, indptr, indices, v, pruned
        self.hop_mask, self.stamps, self.cone, self.counts = hop_mask, stamps, cone, counts

    def __call__(self, lo: int, hi: int, delta_cur, delta_next, L_tgt, sweep: int,
                 level: int) -> None:
        """One BFS level pushed from ``frontier[lo:hi]`` (distinct rows, cap >=
        hi - lo + n), in place and with no host read: the caller reads
        ``counts`` and must raise on ``counts[2]``.  delta_cur and
        delta_next int32[n, wm] (apart), L_tgt int32[>= n, l_max]; ``sweep``
        and ``level`` are int32 ids."""
        n, wm, dev = self.n, self.wm, self.dev
        for name, t in (("delta_cur", delta_cur), ("delta_next", delta_next)):
            if (t.dtype != torch.int32 or t.shape != (n, wm) or not t.is_contiguous()
                    or t.device != dev):
                raise ValueError(f"{name} must be a contiguous int32[{n}, {wm}] tensor on "
                                 f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if delta_cur.data_ptr() == delta_next.data_ptr():
            raise ValueError("delta_cur must not share memory with delta_next")
        if (L_tgt.dtype != torch.int32 or L_tgt.dim() != 2 or not L_tgt.is_contiguous()
                or L_tgt.shape[0] < n or L_tgt.shape[1] < 1 or L_tgt.device != dev):
            raise ValueError(f"L_tgt must be a contiguous int32[>= {n}, l_max] tensor on "
                             f"{dev}, got {L_tgt.dtype} {tuple(L_tgt.shape)} on {L_tgt.device}")
        if not 0 <= lo <= hi or self.frontier.shape[0] < hi - lo + n:
            raise ValueError(f"the ring of {self.frontier.shape[0]} cannot hold rows "
                             f"[{lo}, {hi}) and the next level's up to n = {n}")
        if not (0 <= sweep < 2**31 and 0 <= level < 2**31):
            raise ValueError(f"sweep {sweep} and level {level} must be int32 ids >= 0")
        if dev.type == "meta":
            # the rows pushed: each one's ring entry, CSR bounds and v, pruned
            # and delta words read, its delta words written
            rows = hi - lo
            _meta_cost("frontier_expand", rows * wm, rows * (4 + 16 + 4 * wm * 4))
            return
        if dev.type == "cpu":
            ref.frontier_expand_ref(self.frontier, lo, hi, self.indptr, self.indices, self.v,
                                    self.pruned, delta_cur, delta_next, L_tgt, self.hop_mask,
                                    self.stamps, sweep, level, self.cone, self.counts)
            return
        if hi == lo:
            return
        _launch("frontier_expand", dev, self.frontier.data_ptr(), self.frontier.shape[0], lo,
                hi, self.indptr.data_ptr(), self.indices.data_ptr(), n,
                self.indices.shape[0], self.v.data_ptr(), self.pruned.data_ptr(),
                delta_cur.data_ptr(), delta_next.data_ptr(), wm, L_tgt.data_ptr(),
                L_tgt.shape[1], self.hop_mask.data_ptr(), self.hop_mask.shape[0],
                self.stamps.data_ptr(), sweep, level, self.cone.data_ptr(),
                self.counts.data_ptr())


def frontier_expand(frontier, lo: int, hi: int, indptr, indices, v, pruned, delta_cur,
                    delta_next, L_tgt, hop_mask, stamps, sweep: int, level: int, cone,
                    counts) -> None:
    """K2's frontier form: one BFS level of a construction wave, pushed from
    the rows ``frontier[lo:hi]`` over the CSR ``(indptr, indices)``, in
    place, with no host read (the caller reads ``counts``).
    ``csrc/frontier_expand.cu``'s header and ``ref.frontier_expand_ref``
    define it; ``FrontierExpand`` names the arguments."""
    FrontierExpand(frontier, indptr, indices, v, pruned, hop_mask, stamps, cone, counts)(
        int(lo), int(hi), delta_cur, delta_next, L_tgt, int(sweep), int(level))


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
    if dev.type == "meta":
        # a and x read once, out written; an AND-OR per (row, column, word)
        _meta_cost("bitset_mm", n * k * wm, _nbytes(a, x, out))
        return out
    if n:
        _launch("bitset_mm", dev, a.data_ptr(), n, a.shape[1], x.data_ptr(), k, wm,
                out.data_ptr())
    return out


# device -> the bad-id flag word of ell_spmm and embedding_bag there: (pinned
# host memory, which the kernels write through its mapping, its numpy view,
# the lock the calls on the device share)
_FLAG_WORDS: dict = {}
_FLAG_WORDS_LOCK = threading.Lock()


def _flag_word(dev: torch.device) -> tuple:
    with _FLAG_WORDS_LOCK:
        word = _FLAG_WORDS.get(dev)
        if word is None:
            host = torch.zeros(1, dtype=torch.int32, pin_memory=True)
            word = _FLAG_WORDS[dev] = (host, host.numpy(), threading.Lock())
    return word


def _ell_spmm(nbr: torch.Tensor, wgt: torch.Tensor, x: torch.Tensor,
              count: str = "ell_spmm") -> torch.Tensor:
    """K5 on checked inputs: the kernel on the card (counted as ``count``),
    the plain version on the CPU."""
    dev = _device("ell_spmm", nbr, wgt, x)
    if dev.type == "cpu":
        return ref.ell_spmm_ref(nbr, wgt, x)
    (n, d), (n_src, F) = nbr.shape, x.shape
    out = torch.empty((n, F), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        # every slot valid: its id and weight, its source row gathered; a
        # multiply-add per slot and column; out written
        _meta_cost(count, 2 * n * d * F, n * d * 8 + n * d * F * 4 + n * F * 4)
        return out
    if n == 0:
        return out
    flag, flag_np, lock = _flag_word(dev)
    stream = torch.cuda.current_stream(dev)
    with lock:
        flag_np[0] = 0
        _launch("ell_spmm", dev, nbr.data_ptr(), wgt.data_ptr(), n, d, x.data_ptr(), n_src, F,
                out.data_ptr(), flag.data_ptr(), stream=stream, count=count)
        stream.synchronize()
        bad = bool(flag_np[0])
    if bad:
        raise ValueError(f"ell_spmm: neighbor ids outside [-1, {n_src})")
    return out


class _EllSpmm(torch.autograd.Function):
    """K5 with its backward: ``dx = K5(nbr_t, wgt_t, dout)``, one launch over
    the transposed rows (counted as ``ell_spmm_bwd``)."""

    @staticmethod
    def forward(ctx, nbr, wgt, x, nbr_t, wgt_t):
        ctx.transposed = (nbr_t, wgt_t)
        return _ell_spmm(nbr, wgt, x)

    @staticmethod
    def backward(ctx, dout):
        nbr_t, wgt_t = ctx.transposed
        if nbr_t is None:
            raise ValueError("ell_spmm's backward needs the transposed rows: pass nbr_t "
                             "and wgt_t")
        return None, None, _ell_spmm(nbr_t, wgt_t, dout.contiguous(), "ell_spmm_bwd"), None, None


def ell_spmm(nbr: torch.Tensor, wgt: torch.Tensor, x: torch.Tensor,
             nbr_t=None, wgt_t=None) -> torch.Tensor:
    """K5: the weighted ELL SpMM,
    ``out[i] = sum over s with nbr[i, s] != -1 of wgt[i, s] * x[nbr[i, s]]``,
    accumulated in float32 in slot order.

    nbr: int32[n, d], wgt: float32[n, d], x: float32[n_src, F] ->
    float32[n, F].  Only -1 is padding: any other id outside [0, n_src)
    raises ``ValueError`` (the kernel skips it and sets a flag word in
    pinned host memory).  On the card a call is one launch on the current
    stream and one synchronisation of that stream, after which the flag is
    read on the host, as ``embedding_bag``'s.

    Differentiable in ``x`` (not in ``wgt``, fixed coefficients: a ``wgt``
    that requires grad raises): the backward is K5 over the same matrix
    transposed, ``nbr_t`` int32[n_src, d_t] and ``wgt_t`` float32[n_src, d_t]
    (the rows by source: ``layers.ell_from_edges`` with source and
    destination swapped), ``dx = ell_spmm(nbr_t, wgt_t, dout)``; a backward
    without them raises."""
    _check_matrix("nbr", nbr)
    _check_matrix("wgt", wgt, torch.float32)
    _check_matrix("x", x, torch.float32)
    if wgt.shape != nbr.shape:
        raise ValueError(f"wgt {tuple(wgt.shape)} must match nbr {tuple(nbr.shape)}")
    if wgt.requires_grad:
        raise ValueError("ell_spmm's wgt is fixed coefficients: it takes no gradient")
    if (nbr_t is None) != (wgt_t is None):
        raise ValueError("pass both nbr_t and wgt_t, or neither")
    if nbr_t is not None:
        _check_matrix("nbr_t", nbr_t)
        _check_matrix("wgt_t", wgt_t, torch.float32)
        if wgt_t.shape != nbr_t.shape or nbr_t.shape[0] != x.shape[0]:
            raise ValueError(f"nbr_t {tuple(nbr_t.shape)} and wgt_t {tuple(wgt_t.shape)} must "
                             f"be [n_src = {x.shape[0]}, d_t]")
    if not (torch.is_grad_enabled() and x.requires_grad):   # no gradient: no Function
        return _ell_spmm(nbr, wgt, x)
    return _EllSpmm.apply(nbr, wgt, x, nbr_t, wgt_t)


def _embedding_bag(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K6 on checked inputs: the kernel on the card, the plain version on the
    CPU."""
    dev = _device("embedding_bag", table, idx)
    if dev.type == "cpu":
        return ref.embedding_bag_ref(table, idx)
    (V, D), (B, bag) = table.shape, idx.shape
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        # every slot an id: its row gathered, an add per slot and column
        _meta_cost("embedding_bag", B * bag * D, B * bag * 4 + B * bag * D * 4 + B * D * 4)
        return out
    if B == 0:
        return out
    flag, flag_np, lock = _flag_word(dev)
    stream = torch.cuda.current_stream(dev)
    with lock:
        flag_np[0] = 0
        _launch("embedding_bag", dev, table.data_ptr(), V, D, idx.data_ptr(), B, bag,
                out.data_ptr(), flag.data_ptr(), stream=stream)
        stream.synchronize()
        bad = bool(flag_np[0])
    if bad:
        raise ValueError(f"embedding_bag: ids >= V = {V}")
    return out


class _EmbeddingBag(torch.autograd.Function):
    """K6 with its backward ``embedding_bag_bwd``."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.V = table.shape[0]
        return _embedding_bag(table, idx)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        return embedding_bag_bwd(idx, dout.contiguous(), ctx.V), None


def embedding_bag(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K6: the sum of each bag's rows,
    ``out[b] = sum over s with idx[b, s] >= 0 of table[idx[b, s]]``,
    accumulated in float32 in slot order.

    table: float32[V, D], idx: int32[B, bag] -> float32[B, D].  Every
    negative id is padding; an id >= V raises ``ValueError`` (the kernel
    skips it and sets a flag word in pinned host memory).  On the card a
    call is one launch on the current stream and one synchronisation of
    that stream, after which the flag is read on the host.  Differentiable
    in ``table``: the backward is ``embedding_bag_bwd``."""
    _check_matrix("table", table, torch.float32)
    _check_matrix("idx", idx)
    return _EmbeddingBag.apply(table, idx)


def embedding_bag_bwd(idx: torch.Tensor, dout: torch.Tensor, V: int) -> torch.Tensor:
    """K6's backward, the gradient of ``embedding_bag`` by its table:
    ``dtable[v] = sum over (b, s) with idx[b, s] == v of dout[b]`` over the
    ids ``>= 0`` (an id >= V, which the forward refuses, is skipped).

    idx: int32[B, bag], dout: float32[B, D] -> float32[V, D].  On the card
    ``csrc/embedding_bag_bwd.cu`` zeroes the table and adds with float32
    atomics (their order, so a row's last bits, vary from run to run); on
    the CPU ``ref.embedding_bag_bwd_ref``."""
    _check_matrix("idx", idx)
    _check_matrix("dout", dout, torch.float32)
    if dout.shape[0] != idx.shape[0]:
        raise ValueError(f"dout {tuple(dout.shape)} must have idx's {idx.shape[0]} bags")
    V = int(V)
    dev = _device("embedding_bag_bwd", idx, dout)
    if dev.type == "cpu":
        return ref.embedding_bag_bwd_ref(idx, dout, V)
    (B, bag), D = idx.shape, dout.shape[1]
    dtable = torch.empty((V, D), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        # the ids and dout read, the table written; an add per slot and column
        _meta_cost("embedding_bag_bwd", B * bag * D, _nbytes(idx, dout, dtable))
        return dtable
    _launch("embedding_bag_bwd", dev, idx.data_ptr(), B, bag, dout.data_ptr(), D,
            dtable.data_ptr(), V)
    return dtable


# K4's kernel for each input dtype: bfloat16 on the tensor cores (wgmma),
# float32 on the CUDA cores (the tensor cores would run it as TF32); its
# backward's likewise
ATTENTION_KERNELS = {torch.bfloat16: "flash_attention_sm90", torch.float32: "flash_attention"}
ATTENTION_BWD_KERNELS = {torch.bfloat16: "flash_attention_bwd_sm90",
                         torch.float32: "flash_attention_bwd"}


def attention_kernel(dtype: torch.dtype) -> str:
    """The kernel ``flash_attention`` launches for inputs of ``dtype``: a
    dispatch by dtype alone, never a fall-back from one kernel to the other."""
    try:
        return ATTENTION_KERNELS[dtype]
    except KeyError:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not {dtype}") from None


def attention_bwd_kernel(dtype: torch.dtype) -> str:
    """The kernel ``flash_attention_bwd`` launches for inputs of ``dtype``,
    by dtype alone as ``attention_kernel``."""
    try:
        return ATTENTION_BWD_KERNELS[dtype]
    except KeyError:
        raise ValueError(f"flash_attention_bwd takes float32 or bfloat16, not {dtype}") from None


def attention_pairs(S: int, T: int, causal: bool, window) -> tuple:
    """(pairs, keys) of K4's masks over S queries right-aligned to T keys:
    the (query, key) pairs kept, what the computation needs, and the keys
    some query sees, what it must read of k and v."""
    qpos = np.arange(S, dtype=np.int64) + T - S
    hi = np.minimum(qpos, T - 1) if causal else np.full(S, T - 1, np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(S, np.int64)
    ok = hi >= lo
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    if not ok.any():
        return pairs, 0
    # the rows' intervals are sorted by both ends: their union's length
    lo, hi = lo[ok], hi[ok]
    start = np.maximum(lo, np.concatenate([[lo[0]], np.maximum.accumulate(hi)[:-1] + 1]))
    return pairs, int(np.maximum(hi - start + 1, 0).sum())


# K4's float32 short-row kernel (csrc/flash_attention.cu): a (batch, kv head)
# with fewer packed query rows (rep * S) than ATTENTION_TILE_ROWS is read in
# 32-key chunks by blocks of ``attention_rows_a_block`` rows; the keys a block
# can see are cut into ``splits`` pieces of whole chunks, a block a piece, so
# that a decode's few heads still spread over the card, and a second launch
# merges the pieces' partial softmaxes.  The rules below are the kernel's.
ATTENTION_TILE_ROWS = 64     # packed rows from which the tiled kernel runs
ATTENTION_CHUNK = 32         # keys a tile of the short-row kernel, a piece's unit
ATTENTION_MIN_PIECE = 2      # chunks a piece holds at least, unless the keys are fewer
ATTENTION_MAX_SPLITS = 128   # the merge kernel's limit
H100_SMS = 132
_SMS: dict = {}


def attention_rows_a_block(rows: int) -> int:
    """The query rows a block of the short-row kernel owns: the least power
    of two at least ``rows``, at most 16."""
    return next(r for r in (1, 2, 4, 8, 16) if rows <= r or r == 16)


def attention_key_chunks(S: int, rep: int, kv_len: int, causal: bool, window) -> list:
    """For each row tile of the short-row kernel (``attention_rows_a_block``
    rows of the ``rep * S`` packed rows, row r at position ``r // rep``):
    ``(k_begin, k_end, c_lo, n_chunks)``, the keys some row of the tile can
    see and the 32-key chunks from chunk ``c_lo`` that hold them (0 chunks
    where no row sees a key)."""
    rows = rep * S
    R = attention_rows_a_block(rows)
    out = []
    for r0 in range(0, rows, R):
        nr = min(R, rows - r0)
        s_first, s_last = r0 // rep, (r0 + nr - 1) // rep
        k_end = min(kv_len, s_last + kv_len - S + 1) if causal else kv_len
        k_begin = max(0, s_first + kv_len - S - window + 1) if window is not None else 0
        c_lo = k_begin // ATTENTION_CHUNK
        n = -(-k_end // ATTENTION_CHUNK) - c_lo if k_end > k_begin else 0
        out.append((k_begin, k_end, c_lo, n))
    return out


@functools.lru_cache(maxsize=4096)   # a decode step asks once a layer
def attention_split_plan(B: int, Hkv: int, rep: int, S: int, kv_len: int, causal: bool,
                         window, sms: int = H100_SMS) -> int:
    """``splits``, the pieces the short-row kernel cuts each tile's keys into
    (1 on the tiled kernel): enough that B x Hkv x row tiles x splits blocks
    fill the ``sms`` multiprocessors about twice, each piece at least
    ATTENTION_MIN_PIECE chunks, at most ATTENTION_MAX_SPLITS, then as few as
    give the longest tile the same piece length.  A grid that already has a
    block for each multiprocessor takes 1."""
    if rep * S >= ATTENTION_TILE_ROWS:
        return 1
    tiles = attention_key_chunks(S, rep, kv_len, causal, window)
    base = B * Hkv * len(tiles)
    n_max = max(n for *_, n in tiles)
    if base >= sms or n_max <= 1:
        return 1
    splits = min(-(-2 * sms // base), -(-n_max // ATTENTION_MIN_PIECE), ATTENTION_MAX_SPLITS)
    per = -(-n_max // splits)
    return -(-n_max // per)


def attention_pieces(S: int, rep: int, kv_len: int, causal: bool, window, splits: int) -> list:
    """The short-row kernel's pieces: for each row tile, ``(k_begin, k_end,
    [(first, end), ...])``, piece i holding the keys ``[first, end)`` of
    whole 32-key chunks (``first == end``: an empty piece), as its blocks
    cut them: ``per = ceil(n_chunks / splits)`` chunks a piece."""
    out = []
    for k_begin, k_end, c_lo, n in attention_key_chunks(S, rep, kv_len, causal, window):
        per = -(-n // splits)
        pieces = [((c_lo + min(i * per, n)) * ATTENTION_CHUNK,
                   (c_lo + min((i + 1) * per, n)) * ATTENTION_CHUNK) for i in range(splits)]
        out.append((k_begin, k_end, pieces))
    return out


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev.index]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None, scale=None,
                    kv_len=None, return_lse: bool = False):
    """K4: softmax attention with causal, sliding-window and GQA masks, the
    semantics of ``repro.kernels.ops.flash_attention``.

    q: [B, Hq, S, D], k: [B, Hkv, T, D] and v: [B, Hkv, T, Dv], all float32
    or all bfloat16, contiguous -> q's dtype [B, Hq, S, Dv].  q head h reads kv head
    ``h // (Hq // Hkv)``.  Query positions are right-aligned to the keys
    (``qpos = s + T - S``); ``causal`` keeps keys ``t <= qpos``; ``window``
    (None or an int) keeps ``t > qpos - window``, also without ``causal``.
    A row that keeps no key gives 0.  ``scale`` defaults to ``1/sqrt(D)``,
    q's width (taken in float32).  ``kv_len`` (default T) is the number of keys that
    exist: keys ``t >= kv_len`` are neither read nor seen and the queries are
    right-aligned to ``kv_len`` (``qpos = s + kv_len - S``), so a decode step
    attends over the filled prefix of a preallocated ``[B, Hkv, T, D]``
    cache without copying it.  Needs Hq a multiple of Hkv, D and Dv multiples
    of 8 with ``8 <= Dv <= D <= 192`` and ``Dv <= 128`` (MLA's prefill is
    D = 192, Dv = 128), S, T >= 1, and q, k and v 16-byte aligned (on either
    device, so both take the same inputs).  Logits, the softmax and the
    output accumulate in float32.

    On the card, bfloat16 runs ``csrc/flash_attention_sm90.cu`` (both
    products on the tensor cores, counted as ``flash_attention_sm90``) and
    float32 ``csrc/flash_attention.cu`` (the CUDA cores, counted as
    ``flash_attention``); ``attention_kernel`` picks by dtype.  A float32
    head of fewer than 64 packed rows (decode) runs the short-row kernel
    over ``attention_split_plan``'s pieces of its keys and, for more than
    one, a merge launch with a workspace this wrapper allocates; each call
    counts once, whatever it launches.
    Differentiable in q, k and v where ``kv_len`` is T: the backward is
    ``flash_attention_bwd``; a call that needs a gradient also keeps each
    row's log-sum-exp for it (``[B, Hq, S]`` float32).

    With ``return_lse`` the call is inference, outside autograd: ``(out,
    lse)``, lse float32 ``[B, Hq, S]``, each row's base-2 log-sum-exp of
    ``scale log2(e) q k^T`` over its kept keys, ``+inf`` for a row that keeps
    none (both kernels write it; on the CPU
    ``ref.flash_attention_ref(..., return_lse=True)``).  A decode over a
    cache split along its sequence merges the ranks' rows by it
    (``dist.split_softmax.combine``)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dim() != 4 or not t.is_contiguous()
                or t.dtype not in (torch.float32, torch.bfloat16)):
            raise ValueError(f"{name} must be a contiguous 4-D float32 or bfloat16 tensor, "
                             f"got {t.dtype} {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    if v.shape[:3] != k.shape[:3] or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[{B}, Hkv, T, {D}] and [{B}, Hkv, T, Dv]")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq = {Hq} must be a multiple of Hkv = {Hkv}")
    if D % 8 or not 8 <= D <= 192:
        raise ValueError(f"head dim D = {D} must be a multiple of 8 in [8, 192]")
    if Dv % 8 or not 8 <= Dv <= min(D, 128):
        raise ValueError(f"value head dim Dv = {Dv} must be a multiple of 8 in "
                         f"[8, min(D, 128)], D = {D}")
    if S < 1 or T < 1:
        raise ValueError(f"S = {S} and T = {T} must be at least 1")
    kv_len = T if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= T:
        raise ValueError(f"kv_len = {kv_len} must be in [1, T = {T}]")
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
    if dev.type == "cuda" and (B > 65535 or Hkv > 65535):
        raise ValueError(f"B = {B} and Hkv = {Hkv} must be at most 65,535 (grid size)")
    if return_lse:
        with torch.no_grad():
            return _flash_attention(q, k, v, bool(causal), window, scale, kv_len,
                                    return_lse=True)
    # the backward of either dtype reads the forward's log-sum-exp: kept where
    # autograd will call the backward
    keep_lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, bool(causal), window, scale, kv_len, keep_lse)


def _flash_attention(q, k, v, causal: bool, window, scale: float, kv_len: int,
                     return_lse: bool = False):
    """K4's forward on checked inputs: the kernel of q's dtype on the card,
    the plain version on the CPU.  With ``return_lse`` also each row's
    base-2 log-sum-exp: ``(out, lse)``."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                       kv_len=kv_len, return_lse=return_lse)
    dev = q.device
    B, Hq, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    kernel = attention_kernel(q.dtype)
    # aligned: the sm90 kernel writes 16 bytes at a time
    out = torch.empty((B, Hq, S, Dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev) if return_lse else None
    if dev.type == "meta":
        pairs, keys = attention_pairs(S, kv_len, causal, window)
        e = q.element_size()
        _meta_cost(kernel, 2 * pairs * (D + Dv) * Hq * B,
                   B * Hq * S * (D + Dv) * e + B * Hkv * keys * (D + Dv) * e
                   + (lse.numel() * 4 if return_lse else 0))
        return (out, lse) if return_lse else out
    if not B:
        return (out, lse) if return_lse else out
    # a null lse pointer asks either kernel for none
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, B, Hq, Hkv, S, T, kv_len, D, Dv,
            int(bool(causal)), window is not None, 0 if window is None else int(window), scale)
    if kernel == "flash_attention":   # the pieces' partials go to a workspace, merged after
        splits = attention_split_plan(B, Hkv, Hq // Hkv, S, kv_len, causal, window,
                                      _sm_count(dev))
        work = (torch.empty(B * Hq * S * splits * (Dv + 2), dtype=torch.float32, device=dev)
                if splits > 1 else None)
        args += (None if work is None else work.data_ptr(), splits)
    _launch(kernel, dev, *args)
    return (out, lse) if return_lse else out


class _FlashAttention(torch.autograd.Function):
    """K4 with its backward ``flash_attention_bwd`` (over all T keys: a call
    with ``kv_len < T``, a decode step's, has no backward).  With
    ``keep_lse`` (a call that needs a gradient) the forward keeps each row's
    log-sum-exp for the backward (under ``torch.utils.checkpoint`` the
    recomputed forward keeps it again)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kv_len, keep_lse):
        lse = None
        if keep_lse:
            out, lse = _flash_attention(q, k, v, causal, window, scale, kv_len,
                                        return_lse=True)
        else:
            out = _flash_attention(q, k, v, causal, window, scale, kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, kv_len = ctx.args
        if kv_len != k.shape[2]:
            raise ValueError(f"flash_attention's backward takes kv_len = T only, not "
                             f"{kv_len} of {k.shape[2]}")
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), causal=causal,
                                         window=window, scale=scale, lse=lse)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, causal: bool = True, window=None,
                        scale=None, lse=None) -> tuple:
    """K4's backward: the gradients (dq, dk, dv) of ``flash_attention(q, k,
    v, causal, window, scale)`` over all T keys, given its output ``o`` and
    the output's gradient ``do`` ([B, Hq, S, Dv], q's dtype).  dk and dv sum
    over each GQA group; a row that sees no key adds nothing.  Each gradient
    is in its input's dtype, accumulated in float32.  ``lse`` is the
    forward's float32 ``[B, Hq, S]`` base-2 log-sum-exp of ``scale log2(e)
    q k^T`` per row (+inf without a key), as K4's forward keeps it in
    training; without it one launch of K4's forward first makes it on the
    card (counted under the forward's name).

    On the card ``attention_bwd_kernel`` picks by dtype, and each call counts
    once as ``flash_attention_bwd``.  bfloat16:
    ``csrc/flash_attention_bwd_sm90.cu`` (the tensor cores; three launches:
    delta and a zeroed float32 dq accumulator, dk and dv a 64-key tile with
    dq's parts added atomically, dq rounded), also counted as
    ``flash_attention_bwd_sm90``.  float32: ``csrc/flash_attention_bwd.cu``
    (the CUDA cores; two launches: delta and dq zeroed, dk and dv a 64-key
    tile with dq's parts added atomically).  Atomic order leaves dq's last
    bits varying from run to run.  On the CPU ``ref.flash_attention_bwd_ref``
    with ``lse``."""
    B, Hq, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t, shape in (("k", k, (B, Hkv, T, D)), ("v", v, (B, Hkv, T, Dv)),
                           ("o", o, (B, Hq, S, Dv)), ("do", do, (B, Hq, S, Dv))):
        if tuple(t.shape) != shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)} contiguous={t.is_contiguous()}")
    if not q.is_contiguous() or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"q must be contiguous and Hq = {Hq} a multiple of Hkv = {Hkv}")
    if D % 8 or Dv % 8 or not 8 <= Dv <= min(D, 128) or D > 192:
        raise ValueError(f"widths D = {D}, Dv = {Dv} outside 8 <= Dv <= D <= 192, Dv <= 128")
    if lse is not None and (tuple(lse.shape) != (B, Hq, S) or lse.dtype != torch.float32
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(B, Hq, S)}, got {lse.dtype} "
                         f"{tuple(lse.shape)} contiguous={lse.is_contiguous()}")
    kernel = attention_bwd_kernel(q.dtype)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    tensors = (q, k, v, o, do) + (() if lse is None else (lse,))
    dev = _device("flash_attention_bwd", *tensors)
    if dev.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window,
                                           scale=scale, lse=lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dev.type == "meta":
        # q, k, v, o, do (and lse) read, dq, dk, dv written; the logits, dP and
        # the three products over the pairs the masks keep
        pairs, _ = attention_pairs(S, T, causal, window)
        _meta_cost("flash_attention_bwd", 2 * pairs * (3 * D + 2 * Dv) * Hq * B,
                   2 * _nbytes(q, k, v) + _nbytes(o, do) + (B * Hq * S * 4))
        return dq, dk, dv
    if not B:
        return dq, dk, dv
    masks = (int(bool(causal)), window is not None, 0 if window is None else int(window))
    if lse is None:
        _, lse = _flash_attention(q, k, v, causal, window, scale, T, return_lse=True)
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
    if kernel == "flash_attention_bwd":   # float32: dq zeroed and added into by the kernel
        # its tiles come in 16 bytes a copy: a view off a 16-byte line is copied
        q, k, v, o, do = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v, o, do))
        _launch(kernel, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), B, Hq, Hkv, S, T, D, Dv, *masks, scale)
        return dq, dk, dv
    dq_acc = torch.empty((B, Hq, S, D), dtype=torch.float32, device=dev)   # zeroed by the kernel
    _launch(kernel, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, S, T, D, Dv, *masks,
            scale, count="flash_attention_bwd")
    LAUNCHES[kernel] += 1
    return dq, dk, dv
