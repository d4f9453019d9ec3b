"""The port's numpy copies and K2's plain version against the JAX package.

  * ``repro_torch.build.waves`` (``wave_schedule`` with both schedulers and
    the probe's early abort, ``speculative_schedule``, ``dfs_intervals``)
    gives arrays equal to ``repro.build.waves``'s on the five construction
    families and ``random_dag(5000, 12000)``;
  * ``repro_torch.build.bitset`` equals ``repro.build.bitset``;
  * ``kernels.ref.frontier_or_ref`` and the CPU path of
    ``kernels.ops.frontier_or`` equal the numpy loop of
    ``tests/test_kernels.py::test_frontier_or_sweep`` (the Pallas kernel
    itself does not run under the installed JAX: ``pl.load`` is gone), at its
    three shapes and at the edges (all-INVALID rows, ids at n_src - 1,
    bit 31 set in every word).
"""
import numpy as np
import pytest
import torch

import repro.build.bitset as jbitset
import repro.build.waves as jwaves
import repro.graph.generators as jgen
import repro_torch.build.bitset as tbitset
import repro_torch.build.waves as twaves
import repro_torch.graph.csr as tcsr
from repro.core.order import get_order
from repro_torch.kernels import ops, ref
from test_build_engine import _dag_families


def _graphs():
    out = list(_dag_families(np.random.default_rng(0)))
    out.append(("random_dag_5000", jgen.random_dag(5000, 12000, seed=0)))
    return [(name, g, tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())) for name, g in out]


GRAPHS = _graphs()
IDS = [g[0] for g in GRAPHS]


def _eq(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# abort_below_avg=24: random_dag_5000 (mean wave 13.2) aborts, returning None
@pytest.mark.parametrize("abort", [None, 8.0, 24.0])
@pytest.mark.parametrize("scheduler", ["onepass", "blocked"])
@pytest.mark.parametrize("name,jg,tg", GRAPHS, ids=IDS)
def test_wave_schedule_equal(name, jg, tg, scheduler, abort):
    order = get_order(jg, "degree_product")
    for max_wave in (7, 64, 256):
        j = jwaves.wave_schedule(jg, order, max_wave=max_wave, scheduler=scheduler,
                                 abort_below_avg=abort)
        t = twaves.wave_schedule(tg, order.copy(), max_wave=max_wave, scheduler=scheduler,
                                 abort_below_avg=abort)
        assert _eq(j, t), (name, scheduler, abort, max_wave)


@pytest.mark.parametrize("name,jg,tg", GRAPHS, ids=IDS)
def test_speculative_schedule_equal(name, jg, tg):
    order = get_order(jg, "degree_product")
    j = jwaves.speculative_schedule(jg, order, max_wave=64)
    t = twaves.speculative_schedule(tg, order.copy(), max_wave=64)
    assert _eq(j.lengths, t.lengths) and _eq(j.optimistic, t.optimistic)
    assert j.meta == t.meta
    assert len(j.pairs) == len(t.pairs)
    for a, b in zip(j.pairs, t.pairs):
        if isinstance(a, np.ndarray):
            assert _eq(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("name,jg,tg", GRAPHS, ids=IDS)
def test_dfs_intervals_equal(name, jg, tg):
    for k in (1, 2):
        jp, jl = jwaves.dfs_intervals(jg, n_traversals=k)
        tp, tl = twaves.dfs_intervals(tg, n_traversals=k)
        assert _eq(jp, tp) and _eq(jl, tl)


@pytest.mark.parametrize("width", [1, 4, 16])
@pytest.mark.parametrize("name,jg,tg", GRAPHS, ids=IDS)
def test_ell_slabs_equal(name, jg, tg, width):
    args = (jg.indptr.astype(np.int64), jg.indices.astype(np.int64), jg.n)
    jp, jpos, js = jbitset.ell_slabs(*args, width=width)
    tp, tpos, ts = tbitset.ell_slabs(*(a.copy() if isinstance(a, np.ndarray) else a
                                       for a in args), width=width)
    assert _eq(jp, tp) and _eq(jpos, tpos) and len(js) == len(ts)
    assert all(_eq(a, b) for a, b in zip(js, ts))


def test_bitset_word_primitives_equal(rng):
    for k in (1, 31, 32, 45, 256):
        mat = rng.random((9, k)) < 0.3
        assert _eq(jbitset.pack_bool_rows_u32(mat), tbitset.pack_bool_rows_u32(mat))
    w = 130
    assert _eq(jbitset.member_bits(w), tbitset.member_bits(w))
    assert _eq(jbitset.prefix_bits(w), tbitset.prefix_bits(w))
    words = rng.integers(0, 2**63 - 1, (40, 3)).astype(np.uint64)
    words[::3] = jbitset.member_bits(w)[rng.integers(0, w, 14)]
    assert _eq(jbitset.popcount_u64(words), tbitset.popcount_u64(words))
    for a, b in zip(jbitset.expand_member_bits(words, w), tbitset.expand_member_bits(words, w)):
        assert _eq(a, b)
    assert _eq(jbitset.masks_to_matrix(words, w), tbitset.masks_to_matrix(words, w))
    keys = rng.integers(0, 10, 40).astype(np.int64)
    for a, b in zip(jbitset.group_or(keys, words), tbitset.group_or(keys, words)):
        assert _eq(a, b)
    v_bits, a_bits = words[:20], words[20:]
    assert _eq(jbitset.touch_matrix(v_bits, a_bits, w), tbitset.touch_matrix(v_bits, a_bits, w))
    m = [rng.integers(0, 2**63 - 1, (w, 3)).astype(np.uint64) for _ in range(4)]
    assert _eq(jbitset.violation_mask(*m), tbitset.violation_mask(*m))
    g = jgen.random_dag(40, 120, seed=3)
    verts = np.array([0, 5, 17], dtype=np.int64)
    ip, ix = g.indptr.astype(np.int64), g.indices.astype(np.int64)
    for a, b in zip(jbitset.csr_gather(ip, ix, verts), tbitset.csr_gather(ip, ix, verts)):
        assert _eq(a, b)


# ---------------------------------------------------------------- K2, plain


def _numpy_loop(nbr, f):
    """The reference loop of tests/test_kernels.py::test_frontier_or_sweep."""
    r, d = nbr.shape
    exp = np.zeros((r, f.shape[1]), dtype=np.uint32)
    for i in range(r):
        for s in range(d):
            if nbr[i, s] != -1:
                exp[i] |= f[nbr[i, s]]
    return exp


def _case(rng, r, d, n_src, wm, edge):
    nbr = rng.integers(0, n_src, size=(r, d)).astype(np.int32)
    nbr[rng.random((r, d)) < 0.35] = -1
    f = rng.integers(0, 2**32, size=(n_src, wm), dtype=np.uint32)
    if edge == "all_invalid":
        nbr[: max(r // 2, 1)] = -1
    elif edge == "last_id":
        nbr[:, 0] = n_src - 1
    elif edge == "bit31":
        f |= np.uint32(1 << 31)
    return nbr, f


SHAPES = [(13, 4, 50, 1), (128, 16, 200, 2), (1, 7, 9, 3), (1, 16, 40, 8), (300, 16, 500, 8),
          # the card kernel's edges (tests/tier_slab_cases.py): wm not a multiple
          # of 4, d past its 16 slots a chunk and not a multiple of 4
          (257, 33, 300, 9), (257, 33, 300, 32), (257, 7, 300, 3)]
EDGES = [None, "all_invalid", "last_id", "bit31"]


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("r,d,n_src,wm", SHAPES)
def test_frontier_or_plain_matches_numpy_loop(rng, r, d, n_src, wm, edge):
    nbr, f = _case(rng, r, d, n_src, wm, edge)
    exp = _numpy_loop(nbr, f)
    tn, tf = torch.from_numpy(nbr), torch.from_numpy(f.view(np.int32))
    for fn in (ref.frontier_or_ref, ops.frontier_or):
        before = ops.LAUNCHES["frontier_or"]
        got = fn(tn, tf)
        assert ops.LAUNCHES["frontier_or"] == before  # the CPU path launches nothing
        assert got.dtype == torch.int32 and tuple(got.shape) == (r, wm)
        assert np.array_equal(got.numpy().view(np.uint32), exp)
    if edge == "bit31":  # every row with a valid slot carries bit 31 in every word
        assert (exp[(nbr != -1).any(1)] >> np.uint32(31)).all()


@pytest.mark.parametrize("r,d,n_src,wm", SHAPES)
def test_frontier_or_fused_form_matches_numpy_loop(rng, r, d, n_src, wm):
    """out[perm[i]] |= acc[i] in place; flags[0] says whether a word gained
    a bit, flags[1] stays 0 on valid ids."""
    nbr, f = _case(rng, r, d, n_src, wm, "bit31")
    n_out = r + 5
    perm = rng.permutation(n_out)[:r].astype(np.int64)
    out0 = rng.integers(0, 2**32, size=(n_out, wm), dtype=np.uint32)
    exp = out0.copy()
    exp[perm] |= _numpy_loop(nbr, f)
    out = torch.from_numpy(out0.view(np.int32).copy())
    flags = torch.zeros(2, dtype=torch.int32)
    got = ops.frontier_or(torch.from_numpy(nbr), torch.from_numpy(f.view(np.int32)),
                          out=out, perm=torch.from_numpy(perm), flags=flags)
    assert got is out and np.array_equal(out.numpy().view(np.uint32), exp)
    assert flags.tolist() == [int(not np.array_equal(exp, out0)), 0]
    flags.zero_()  # a second pass adds nothing
    ops.frontier_or(torch.from_numpy(nbr), torch.from_numpy(f.view(np.int32)),
                    out=out, perm=torch.from_numpy(perm), flags=flags)
    assert flags.tolist() == [0, 0]


def test_frontier_or_bad_ids():
    f = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    for bad in (6, -2):
        nbr = torch.tensor([[0, bad], [1, -1]], dtype=torch.int32)
        with pytest.raises(ValueError, match="outside"):
            ops.frontier_or(nbr, f)
        # the fused form skips the id and flags it
        out = torch.zeros((2, 2), dtype=torch.int32)
        flags = torch.zeros(2, dtype=torch.int32)
        ops.frontier_or(nbr, f, out=out, perm=torch.tensor([1, 0]), flags=flags)
        assert flags.tolist() == [1, 1]
        assert out.tolist() == [[2, 3], [0, 1]]


def test_frontier_or_wrapper_checks():
    nbr = torch.zeros((3, 2), dtype=torch.int32)
    f = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.frontier_or(nbr.long(), f)
    with pytest.raises(ValueError, match="int32"):
        ops.frontier_or(nbr, f.t())
    with pytest.raises(ValueError, match="fused form"):
        ops.frontier_or(nbr, f, perm=torch.zeros(3, dtype=torch.int64))
    out = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="perm"):
        ops.frontier_or(nbr, f, out=out, perm=torch.zeros(2, dtype=torch.int64),
                        flags=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="flags"):
        ops.frontier_or(nbr, f, out=out, perm=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="share memory"):
        ops.frontier_or(nbr, out, out=out, perm=torch.zeros(3, dtype=torch.int64),
                        flags=torch.zeros(2, dtype=torch.int32))
    assert tuple(ops.frontier_or(torch.zeros((0, 2), dtype=torch.int32), f).shape) == (0, 2)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 16])
def test_or_reduce(rng, n):
    x = rng.integers(-2**31, 2**31, size=(5, n, 3), dtype=np.int64).astype(np.int32)
    got = ref.or_reduce(torch.from_numpy(x), dim=1).numpy()
    exp = np.bitwise_or.reduce(x, axis=1) if n else np.zeros((5, 3), np.int32)
    assert np.array_equal(got, exp)
