"""K2's frontier form (``frontier_expand``) against the dense BFS level it
replaces, and the device build around it.

  * a BFS level pushed from the frontier (``kernels.ref.frontier_expand_ref``)
    gives, after every level, the visited words of the dense level
    ``v | expand(v & ~pruned)``: JAX's (``engine_jax._expand_fn`` with
    ``expand="xla"``) and the port's slab form (``frontier_or_ref`` over
    ``bitset.ell_slabs``), from the same seeded wave, hop mask and label
    rows, on the five serve-test graph families in both sweep directions.
    The cone equals the visited rows, a level's claims equal the rows whose
    words it changed, both forms take as many levels, and the swept
    ``labeled`` masks are equal.  Exact: these are bit patterns;
  * the plain version equals a numpy loop on the card tests' edge cases
    (``frontier_cases.py``), and the CPU wrapper launches nothing;
  * a sweep leaves the build's state zero, and two builds in a row with
    different wave schedules are byte-identical to the reference build.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.build.bitset as jbitset
import repro.build.engine as jengine
import repro.build.engine_jax as jengine_jax
import repro.graph.generators as jgen
import repro_torch.build.bitset as tbitset
import repro_torch.build.engine_device as tdev
import repro_torch.graph.csr as tcsr
from frontier_cases import ARRAYS, CASES, ORDER, assert_same_level, make_case, numpy_level
from repro_torch.kernels import ops, ref
from test_serve_engine import _graph_families

FAMILIES = _graph_families(np.random.default_rng(0))
W, L_MAX = 40, 6


def _torch_case(c):
    return {k: (torch.from_numpy(c[k].copy()) if k in ARRAYS else c[k]) for k in ORDER}


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_numpy_loop(name):
    case = make_case(np.random.default_rng(CASES.index(name)), name)
    exp = numpy_level(case)
    for fn in (ref.frontier_expand_ref, ops.frontier_expand):
        t = _torch_case(case)
        before = dict(ops.LAUNCHES)
        fn(*(t[k] for k in ORDER))
        assert ops.LAUNCHES == before  # the CPU path launches nothing
        got = {k: (t[k].numpy() if k in ARRAYS else t[k]) for k in ORDER}
        assert_same_level(case, got, exp, name)
    assert int(exp["counts"][2]) == int(name.startswith("bad_")), name
    if name == "pruned":   # fully pruned rows push nothing
        assert np.array_equal(exp["v"], case["v"])
        assert exp["counts"][0] == case["counts"][0]
    if name == "contention":
        assert exp["counts"][0] > case["counts"][0]


def test_wrapper_refuses_bad_arguments():
    t = _torch_case(make_case(np.random.default_rng(0), "wm2"))
    args = lambda **kw: [kw.get(k, t[k]) for k in ORDER]  # noqa: E731
    bad = [dict(v=t["v"].long()),                                   # dtype
           dict(pruned=t["pruned"][:-1].contiguous()),              # rows
           dict(delta_next=t["delta_cur"]),                         # aliasing
           dict(stamps=t["stamps"][:2].contiguous()),               # shape
           dict(counts=t["counts"][:2].contiguous()),               # size
           dict(indptr=t["indptr"].int()),                          # dtype
           dict(frontier=t["frontier"][:10].contiguous()),          # ring too small
           dict(lo=t["hi"] + 1),                                    # lo > hi
           dict(level=-1)]                                          # id
    for kw in bad:
        with pytest.raises(ValueError):
            ops.frontier_expand(*args(**kw))


# ---------------------------------------------------- against the dense level


def _members(rng, n, w):
    members = rng.choice(n, min(w, n), replace=False)
    j = np.arange(members.size)
    return members, j // 32, (np.uint32(1) << (j % 32).astype(np.uint32))


def _dense_levels_jax(g_pull, n, wm, members, word, bit, L_tgt, hop_mask):
    """JAX's dense level (``engine_jax._make_wave_step``'s body, with
    ``_expand_fn(expand="xla")`` over the pull graph's slabs), level by
    level: the visited words after each level, and the final verdicts."""
    perm, pos_of, slabs = jbitset.ell_slabs(g_pull.indptr.astype(np.int64),
                                            g_pull.indices.astype(np.int64), n, width=4)
    expand = jengine_jax._expand_fn(slabs, pos_of, n, wm, "xla", False, 128, None)
    tgt_hops = jnp.asarray(np.where(L_tgt[:n] != -1, L_tgt[:n], n))
    hop = jnp.asarray(hop_mask.view(np.uint32))
    v = np.zeros((n, wm), np.uint32)
    v[members, word] = bit
    v = jnp.asarray(v)
    pruned = jnp.zeros((n, wm), jnp.uint32)
    computed = jnp.zeros(n, bool)
    out = []
    while True:
        need = (v != 0).any(axis=1) & ~computed
        verd = jnp.bitwise_or.reduce(hop[tgt_hops], axis=1)
        pruned = jnp.where(need[:, None], verd, pruned)
        computed = computed | need
        new = v | expand(v & ~pruned)
        out.append(np.asarray(new).view(np.int32))
        if bool(jnp.all(new == v)):
            return out, np.asarray(pruned).view(np.int32)
        v = new


def _dense_levels_port(g_pull, n, wm, members, word, bit, L_tgt, hop_mask):
    """The port's dense level before the frontier form: K2's slab form
    (``frontier_or_ref``, fused) over the pull graph's slabs."""
    perm, _, slabs = tbitset.ell_slabs(g_pull.indptr.astype(np.int64),
                                       g_pull.indices.astype(np.int64), n, width=4)
    slabs = [torch.from_numpy(np.ascontiguousarray(s)) for s in slabs]
    perm = torch.from_numpy(perm)
    L = torch.from_numpy(L_tgt[:n]).long()
    hop = torch.from_numpy(hop_mask)
    v = torch.zeros((n, wm), dtype=torch.int32)
    v[torch.from_numpy(members), torch.from_numpy(word)] = torch.from_numpy(bit.view(np.int32))
    pruned = torch.zeros_like(v)
    computed = torch.zeros(n, dtype=torch.bool)
    out = []
    while True:
        need = v.ne(0).any(1) & ~computed
        idx = need.nonzero().squeeze(1)
        pruned[idx] = ref.or_reduce(hop[torch.where(L[idx] != -1, L[idx], n)], dim=1)
        computed |= need
        flags = torch.zeros(2, dtype=torch.int32)
        f = v & ~pruned
        for slab in slabs:
            ref.frontier_or_ref(slab, f, out=v, perm=perm[: slab.shape[0]], flags=flags)
        out.append(v.numpy().copy())
        assert flags[1] == 0
        if not flags[0]:
            return out, pruned.numpy()


@pytest.mark.parametrize("direction", ["rev", "fwd"])
@pytest.mark.parametrize("family", range(len(FAMILIES)))
def test_level_matches_dense_level(family, direction):
    name, g = FAMILIES[family]
    n = g.n
    rng = np.random.default_rng(100 + family)
    members, word, bit = _members(rng, n, W)
    wm = (members.size + 31) // 32
    L_tgt = rng.integers(0, n, (n + 1, L_MAX)).astype(np.int32)
    L_tgt[rng.random((n + 1, L_MAX)) < 0.5] = -1
    hop_mask = (rng.integers(0, 2**32, (n + 2, wm), dtype=np.uint32)
                & rng.integers(0, 2**32, (n + 2, wm), dtype=np.uint32)
                & rng.integers(0, 2**32, (n + 2, wm), dtype=np.uint32))
    hop_mask[rng.random(n + 2) < 0.6] = 0
    hop_mask[n] = 0   # the dense forms park INVALID label entries on row n
    hop_mask = hop_mask.view(np.int32)
    # the reverse sweep pulls over out-neighbors and pushes to in-neighbors
    g_rev = g.reverse()
    g_pull, g_push = (g, g_rev) if direction == "rev" else (g_rev, g)
    args = (n, wm, members, word, bit, L_tgt, hop_mask)
    j_levels, j_pruned = _dense_levels_jax(g_pull, *args)
    tg_pull = tcsr.CSRGraph(g_pull.indptr.copy(), g_pull.indices.copy())
    p_levels, p_pruned = _dense_levels_port(tg_pull, *args)

    # the frontier form, level by level from the members
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    indptr, indices = t(g_push.indptr.astype(np.int64)), t(g_push.indices.astype(np.int32))
    v = torch.zeros((n, wm), dtype=torch.int32)
    v[t(members), t(word)] = t(bit.view(np.int32))
    pruned = torch.zeros_like(v)
    delta = torch.zeros((2, n, wm), dtype=torch.int32)
    delta[0] = v
    stamps = torch.full((3, n), -1, dtype=torch.int32)
    stamps[2, t(members)] = 0
    frontier = torch.zeros(2 * n, dtype=torch.int32)
    frontier[: members.size] = t(members.astype(np.int32))
    cone = torch.zeros(n, dtype=torch.int32)
    cone[: members.size] = t(members.astype(np.int32))
    counts = torch.tensor([members.size, members.size, 0])
    lo, hi, cur, levels = 0, members.size, 0, []
    while True:
        before = v.clone()
        ref.frontier_expand_ref(frontier, lo, hi, indptr, indices, v, pruned, delta[cur],
                                delta[1 - cur], t(L_tgt), t(hop_mask), stamps, 0,
                                len(levels), cone, counts)
        levels.append(v.numpy().copy())
        ring, n_cone, bad = counts.tolist()
        assert bad == 0
        assert np.array_equal(levels[-1], j_levels[len(levels) - 1]), (name, len(levels))
        assert np.array_equal(levels[-1], p_levels[len(levels) - 1]), (name, len(levels))
        visited = set(np.flatnonzero(v.ne(0).any(1).numpy()))
        assert set(cone[:n_cone].tolist()) == visited and n_cone == len(visited)
        changed = set(np.flatnonzero((v != before).any(1).numpy()))
        claimed = frontier[torch.arange(hi, ring) % (2 * n)].tolist()
        assert len(claimed) == len(changed) and set(claimed) == changed
        if ring == hi:
            break
        lo, hi, cur = hi, ring, 1 - cur
    assert len(levels) == len(j_levels) == len(p_levels)
    assert not delta.any()   # every gained bit was pushed, and cleared
    labeled = [lv & ~pr for lv, pr in ((levels[-1], pruned.numpy()),
                                       (j_levels[-1], j_pruned), (p_levels[-1], p_pruned))]
    assert np.array_equal(labeled[0], labeled[1]) and np.array_equal(labeled[0], labeled[2])
    assert labeled[0].any(), name


# ------------------------------------------------------- the build around it


def test_sweep_leaves_the_state_zero():
    """Sweeps of two different waves on one ``_SweepState``: after each, the
    visited words, deltas and hop rows the sweep touched are zero again
    (``pruned`` keeps verdicts that the next sweep's stamps mark stale), and
    its labels equal the same sweep's on a fresh state."""
    jg = jgen.layered_dag(200, avg_out=2.0, seed=5).reverse()
    csr = (torch.from_numpy(jg.indptr.astype(np.int64)),
           torch.from_numpy(jg.indices.astype(np.int32)))
    n, w, l_max, held = jg.n, 64, 64, 6
    rng = np.random.default_rng(2)
    labels = lambda: np.where(rng.random((n + 1, l_max)) < 0.3, -1,  # noqa: E731
                              rng.integers(0, n, (n + 1, l_max))).astype(np.int32)
    L_src = torch.from_numpy(labels())
    L_held = labels()
    L_held[:, held:] = -1      # each row holds ``held`` entries, some INVALID
    used = tdev._SweepState(n, w, "cpu")
    for wlen in (64, 17):
        members = torch.from_numpy(rng.choice(n, wlen, replace=False))
        ranks = torch.arange(wlen, dtype=torch.int32)
        out = []
        for st in (used, tdev._SweepState(n, w, "cpu")):
            L_tgt = torch.from_numpy(L_held.copy())
            len_tgt = torch.full((n,), held, dtype=torch.int32)
            counts = {"levels": 0, "host_reads": 0, "cone_rows": []}
            overflow = tdev._sweep(st, st.expander(*csr), L_src, L_tgt, len_tgt, members,
                                   ranks, counts)
            assert not overflow
            assert counts["host_reads"] == counts["levels"] + 1
            assert counts["cone_rows"][0] >= wlen
            for name in ("v", "delta", "hop_mask"):
                assert not getattr(st, name).any(), name
            assert st.pruned.any()     # the sweep pruned somewhere
            out.append((L_tgt[:n], len_tgt))
        assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
        assert (out[0][1] > held).any()


def test_two_builds_in_a_row():
    """Two device builds in one process, with different wave schedules, are
    each byte-identical to the reference build; each makes one host read a
    level and one a sweep."""
    g = jgen.layered_dag(150, avg_out=2.0, seed=11)
    exp = jengine.build_distribution_labels(g, impl="reference")
    tg = tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())
    for max_wave in (64, 8):
        stats = {}
        got = tdev.distribution_labeling_device(tg, max_wave=max_wave, device="cpu",
                                                stats_out=stats)
        for f in ("L_out", "L_in", "out_len", "in_len", "hop_rank"):
            assert getattr(exp, f).tobytes() == getattr(got, f).tobytes(), (max_wave, f)
        assert stats["host_reads"] == stats["levels"] + stats["sweeps"]
        assert 1 <= stats["cone_rows_mean"] <= stats["cone_rows_p99"] <= stats["cone_rows_max"]
