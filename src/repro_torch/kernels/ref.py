"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, in torch ops.  The kernel
wrappers in ``ops`` run these for tensors on the CPU; on the card, the tests
and ``chip_smoke.py`` hold each kernel against its plain version on the same
inputs.  The serve engine's ``dense`` backend is ``tier_intersect_ref`` on
the engine's device; its ``kernel`` backend runs ``serve_batch_ref`` (K1's
batch form) on a CPU engine and, on a card, never calls them.
``frontier_expand_ref`` is K2's frontier form, the
device wave build's BFS level when the build runs on the CPU;
``frontier_or_ref`` is K2's slab form, the counterpart of
``repro.kernels.ops.frontier_or``, which no build path calls any more.  The
last four (K3-K6) are the plain versions of the kernel library, which no
oracle path calls.
"""
from __future__ import annotations

import math

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


# bit 7 of a serve_batch code: a false verdict the truncated labels cannot prove
SERVE_BATCH_UNCERTAIN = 0x80


def _mask_bits(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a bit mask packed as ``np.packbits`` packs it: row i is
    bit 7 - (i & 7) of byte i >> 3."""
    return ((packed[idx >> 3].long() >> (7 - (idx & 7))) & 1).bool()


def serve_batch_ref(L_out: torch.Tensor, L_in: torch.Tensor, out_len: torch.Tensor,
                    in_len: torch.Tensor, level, widths, queries: torch.Tensor,
                    trunc_out=None, trunc_in=None) -> torch.Tensor:
    """K1's batch form, plain: one code byte per query of a whole serving
    batch, ``2 * fate + verdict`` (the function of ``csrc/serve_batch.cu``).

    queries: int[B, 2] condensation ids; an id in [-n, 0) counts from the
    end, as a numpy index does, and any other id outside [0, n) raises
    ``IndexError``.  ``fate`` is 0 where ``serve.prefilter.apply_prefilters``
    decides the query (its verdict), else 1 + t for the tier t that
    ``serve.planner.plan_batch`` assigns, ``searchsorted(widths, max(out_len[u],
    in_len[v]), side="left")`` clamped to the last tier, with the verdict of
    ``tier_intersect_ref`` at ``widths[t]``.  ``level`` is None or int32[n];
    ``widths`` ascending ints.

    Under a memory budget ``trunc_out`` / ``trunc_in`` are the store's packed
    truncation masks (uint8[ceil(n / 8)], ``np.packbits`` order), and
    ``SERVE_BATCH_UNCERTAIN`` is set on a query with a false verdict, both
    rows truncated, ``u != v`` and (level given) ``level[u] < level[v]``: the
    JAX engine's three-valued epilogue, which leaves the same-vertex and
    level prefilters' verdicts exact."""
    from repro_torch.serve.prefilter import apply_prefilters   # serve imports kernels

    n = L_out.shape[0]
    q = queries.long()
    bad = (q < -n) | (q >= n)
    if bool(bad.any()):
        raise IndexError(f"query ids outside [-{n}, {n}): "
                         f"{q[bad.any(1)][:4].tolist()}")
    q = torch.where(q < 0, q + n, q)
    pf = apply_prefilters(q, out_len, in_len, level)
    need = torch.maximum(out_len[q[:, 0]], in_len[q[:, 1]]).long()
    edges = torch.as_tensor(list(widths), dtype=torch.int64, device=q.device)
    tier = torch.searchsorted(edges, need).clamp_max(edges.numel() - 1)
    fate = torch.where(pf.decided, 0, tier + 1)
    verdict = pf.decided & pf.value
    for t, width in enumerate(widths):
        sel = (fate == t + 1).nonzero().flatten()
        if sel.numel():
            verdict[sel] = tier_intersect_ref(L_out, L_in, q[sel], int(width))
    code = 2 * fate + verdict
    if trunc_out is not None:
        u, v = q[:, 0], q[:, 1]
        unc = _mask_bits(trunc_out, u) & _mask_bits(trunc_in, v) & ~verdict & (u != v)
        if level is not None:
            unc &= level[u] < level[v]
        code = torch.where(unc, code | SERVE_BATCH_UNCERTAIN, code)
    return code.to(torch.uint8)


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


def _or_by_index(index: torch.Tensor, src: torch.Tensor, size: int) -> torch.Tensor:
    """``out[i] = OR of src[j] over j with index[j] == i`` (zeros elsewhere):
    int64[k] indices in [0, size), int32[k, wm] rows -> int32[size, wm].
    torch's scatters have no bitwise OR, so the rows are sorted by index
    and ORed in one pass per multiplicity (a pass never writes one row
    twice)."""
    out = torch.zeros((size, src.shape[1]), dtype=src.dtype, device=src.device)
    if index.numel() == 0:
        return out
    order = torch.argsort(index, stable=True)
    index, src = index[order], src[order]
    mult = torch.bincount(index, minlength=size)
    rank = torch.arange(index.numel(), device=index.device) - (mult.cumsum(0) - mult)[index]
    for r in range(int(mult.max())):
        sel = rank == r
        out[index[sel]] |= src[sel]
    return out


def frontier_expand_ref(frontier, lo, hi, indptr, indices, v, pruned, delta_cur, delta_next,
                        L_tgt, hop_mask, stamps, sweep, level, cone, counts) -> None:
    """K2's frontier form, plain: one BFS level pushed from the rows
    ``frontier[lo:hi]`` (positions mod ``frontier.shape[0]``), in place.  The
    function of ``csrc/frontier_expand.cu``, whose header defines every
    argument; in short, for each frontier row y:

      1. unless ``stamps[1, y] == sweep``: ``pruned[y] = OR over h in L_tgt[y]
         (h != INVALID) of hop_mask[h]`` and ``stamps[1, y] = sweep``;
      2. ``bits = delta_cur[y] & ~pruned[y]``; ``delta_cur[y] = 0``;
      3. every CSR neighbor x of y gets ``v[x] |= bits``; the bits x gained
         are ORed into ``delta_next[x]``, and x, if it gained any, is
         claimed for the next level once (``stamps[0, x] != level``): written
         at ring position ``counts[0]`` (then incremented) and, the first
         time in the sweep (``stamps[2, x] != sweep``), appended to ``cone``
         at ``counts[1]``.

    A frontier id, neighbor id or label entry outside its range, or a CSR
    row outside ``indices``, is skipped and sets ``counts[2] = 1``.  Claims
    are taken in ascending row order (the kernel's order varies from run to
    run; both are read as sets)."""
    n = v.shape[0]
    m = indices.shape[0]
    cap = frontier.shape[0]
    dev = v.device
    ys = frontier[torch.arange(lo, hi, device=dev) % cap].long()
    bad = bool(((ys < 0) | (ys >= n)).any())
    ys = ys[(ys >= 0) & (ys < n)]
    # 1. the verdicts of rows that have none in this sweep
    fresh = ys[stamps[1, ys] != sweep]
    if fresh.numel():
        hops = L_tgt[fresh].long()                                   # [k, l_max]
        ok = (hops >= 0) & (hops < hop_mask.shape[0])
        bad |= bool(((hops != INVALID) & ~ok).any())
        rows = hop_mask[torch.where(ok, hops, 0)]                    # [k, l_max, wm]
        pruned[fresh] = or_reduce(torch.where(ok[:, :, None], rows, 0), dim=1)
        stamps[1, fresh] = sweep
    # 2. the bits each row pushes
    bits = delta_cur[ys] & ~pruned[ys]
    delta_cur[ys] = 0
    # 3. the pushes over the rows' CSR neighbors
    e0, e1 = indptr[ys], indptr[ys + 1]
    row_ok = (e0 >= 0) & (e1 <= m) & (e1 >= e0)
    bad |= bool((~row_ok).any())
    deg = torch.where(row_ok, e1 - e0, 0)
    src = torch.repeat_interleave(torch.arange(ys.numel(), device=dev), deg)
    slot = torch.arange(src.numel(), device=dev) - (deg.cumsum(0) - deg)[src]
    xs = indices[e0[src] + slot].long()
    x_ok = (xs >= 0) & (xs < n)
    bad |= bool((~x_ok).any())
    src, xs = src[x_ok], xs[x_ok]
    targets, inv = torch.unique(xs, return_inverse=True)
    acc = _or_by_index(inv, bits[src], targets.numel())
    old = v[targets]
    gained = acc & ~old
    v[targets] = old | acc
    delta_next[targets] |= gained
    claimed = targets[gained.ne(0).any(1) & (stamps[0, targets] != level)]
    stamps[0, claimed] = level
    p = int(counts[0])
    frontier[(p + torch.arange(claimed.numel(), device=dev)) % cap] = claimed.to(frontier.dtype)
    counts[0] = p + claimed.numel()
    joined = claimed[stamps[2, claimed] != sweep]
    stamps[2, joined] = sweep
    c = int(counts[1])
    room = max(0, min(joined.numel(), n - c))
    cone[c: c + room] = joined[:room].to(cone.dtype)
    counts[1] = c + joined.numel()
    bad |= room < joined.numel()
    if bad:
        counts[2] = 1


# ----------------------------------------------------------- kernel library
# The plain versions of the four kernels that only the public kernel API
# reaches (``repro.kernels.ops``): K3 bitset_mm, K4 flash_attention, K5
# ell_spmm and K6 embedding_bag.


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """int32[n, ceil(k/32)] packed words (int32 bit patterns) -> bool[n, k]:
    bit j of word w is column 32w + j.  Shifts of int32 are arithmetic, so
    each bit is masked with ``& 1`` after the shift (bit 31 reads as 1, not
    as -1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :k].bool()


def bitset_mm_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K3's plain version, the OR-AND boolean product of bit-packed operands
    (the counterpart of ``repro.kernels.ref.bitset_mm_ref``):
    ``out[i] = OR over j < k with bit j of a[i] set of x[j]``.

    a: int32[n, ceil(k/32)], x: int32[k, wm] (int32 bit patterns) ->
    int32[n, wm].  Bits of ``a`` at or beyond ``k`` are ignored.  The OR runs
    over the columns that some row of ``a`` sets, which is every column a
    dense ``a`` sets; the ``[n, columns, wm]`` select is held whole, so a
    caller with a large ``a`` passes it in row chunks."""
    k = x.shape[0]
    if a.shape[1] != (k + 31) // 32:
        raise ValueError(f"a has {a.shape[1]} words per row, k = {k} needs {(k + 31) // 32}")
    a_bool = unpack_bits(a, k)                               # [n, k]
    cols = a_bool.any(dim=0).nonzero().flatten()
    sel = torch.where(a_bool[:, cols, None], x[cols][None], 0)   # [n, cols, wm]
    return or_reduce(sel, dim=1)


def ell_spmm_ref(nbr: torch.Tensor, wgt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K5's plain version, the weighted ELL SpMM (the counterpart of
    ``repro.kernels.ref.ell_spmm_ref``):
    ``out[i] = sum over s with nbr[i, s] != INVALID of wgt[i, s] * x[nbr[i, s]]``.

    nbr: int32[n, d] (only -1 is padding), wgt: float32[n, d], x:
    float32[n_src, F] -> float32[n, F].  Any other id outside [0, n_src)
    raises ``ValueError``.  Holds the ``[n, d, F]`` gather whole."""
    n_src = x.shape[0]
    ids = nbr.long()
    pad = ids == INVALID
    if bool((~pad & ((ids < 0) | (ids >= n_src))).any()):
        raise ValueError(f"ell_spmm: neighbor ids outside [-1, {n_src})")
    gathered = x[torch.where(pad, 0, ids)]                   # [n, d, F]
    w = torch.where(pad, 0.0, wgt)
    return torch.einsum("nd,ndf->nf", w, gathered)


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K6's plain version, the sum of each bag's rows (the counterpart of
    ``repro.kernels.ref.embedding_bag_ref`` with ``offsets_mask = idx >= 0``):
    ``out[b] = sum over s with idx[b, s] >= 0 of table[idx[b, s]]``.

    table: float32[V, D], idx: int32[B, bag] (every negative id is padding)
    -> float32[B, D].  An id >= V raises ``ValueError``."""
    V = table.shape[0]
    ids = idx.long()
    valid = ids >= 0
    if bool((ids >= V).any()):
        raise ValueError(f"embedding_bag: ids >= V = {V}")
    rows = table[torch.where(valid, ids, 0)]                 # [B, bag, D]
    return torch.where(valid[:, :, None], rows, 0.0).sum(dim=1)


def attention_mask(S: int, T: int, causal: bool, window, device) -> torch.Tensor:
    """bool[S, T], true where query s may see key t.  Query positions are
    right-aligned to the keys (``qpos = s + T - S``); ``causal`` keeps
    ``t <= qpos`` and ``window`` keeps ``t > qpos - window`` (a bound from
    below only, also when ``causal`` is False)."""
    qpos = torch.arange(S, device=device)[:, None] + (T - S)
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window=None, scale=None,
                        kv_len=None) -> torch.Tensor:
    """K4's plain version: softmax attention in float32 with the semantics of
    ``repro.kernels.ops.flash_attention`` (the Pallas kernel's), not of
    ``repro.kernels.ref.flash_attention_ref``: a query row with no visible
    key gives 0 (the kernel divides by 1 when the softmax sum is 0; the jnp
    reference gives NaN there).

    q: [B, Hq, S, D], k: [B, Hkv, T, D], v: [B, Hkv, T, Dv] (float32 or
    bfloat16; Hq a multiple of Hkv, q head h reads kv head ``h // (Hq //
    Hkv)``) -> q's dtype [B, Hq, S, Dv].  ``scale`` defaults to
    ``1/sqrt(D)``, q's width.  Only keys
    ``t < kv_len`` (default T) exist: the queries are right-aligned to
    ``kv_len`` and the rest of k and v is never read, which is attention over
    the contiguous prefix ``k[:, :, :kv_len]``.  Holds the
    ``[B, Hq, S, kv_len]`` logits whole."""
    if kv_len is not None:
        k, v = k[:, :, :kv_len], v[:, :, :kv_len]
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Hkv, rep, S, D)       # q heads grouped by kv head
    logits = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) * scale
    mask = attention_mask(S, T, causal, window, q.device)
    logits = logits.masked_fill(~mask, -math.inf)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isinf(m), 0.0, m))   # masked -> 0
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.float()) / torch.where(l == 0, 1.0, l)
    return out.reshape(B, Hq, S, v.shape[3]).to(q.dtype)
