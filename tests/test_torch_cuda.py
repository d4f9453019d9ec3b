"""The port's CUDA kernels on the card, against their plain versions.

K1 (its batch form serve_batch, with and without a budget's truncation
masks, and its tier form label_intersect) and K2 (its slab form frontier_or
and its frontier form frontier_expand) against their plain versions, the
budgeted and the cold-started kernel engine, Hierarchical-Labeling's and
one open-loop daemon run on the card against the host merge and BFS truth,
the dynamic oracle (current epochs through serve_batch, pinned ones through
label_intersect), a durable crash and recovery and the six chaos scenarios
on the card, the device wave build on the
card (through frontier_expand) against the reference build, the sharded
serve backends and the ``mesh=`` device build over a one-rank NCCL mesh,
the kernel library (K3 bitset_mm, K4 flash_attention, also over a
preallocated cache with ``kv_len`` and at MLA's widths, D = 192 and
Dv = 128, K5 ell_spmm, K6 embedding_bag) against its plain versions, the
backwards of K4, K5 and K6 (training) against theirs, the LM family's (MLA
included), the GNN family's and xDeepFM's smoke configs on the card against
the same weights on the CPU, a training step of granite-3-2b's,
xDeepFM's and GCN's on the card against the CPU's, and the production
cells' programs on one rank (``distribute_one`` over a vertex-partitioned
state, the row-sharded serve step) against the CPU's.

These tests need a CUDA card and the CUDA toolkit (the kernels build with
``nvcc`` on first use); they carry the ``cuda`` marker and, without a card,
skip.  The file imports nothing of the JAX package, so it runs on a machine
that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from frontier_cases import ARRAYS, CASES, ORDER, assert_same_level, make_case
from library_cases import (ATTENTION_BWD_CASES, ATTENTION_BWD_TOL, ATTENTION_DV_CASES,
                           ATTENTION_F32_CASES, ATTENTION_LSE_TOL, BAG_BWD_CASES, BAG_CASES,
                           BITSET_CASES, KV_LEN_CASES, SPMM_BAG_BWD_TOL, SPMM_BWD_CASES, SPMM_CASES,
                           attention_rows_seeing_a_key, case_id, make_attention_bwd_case,
                           make_bag_bwd_case, make_bag_case, make_bitset_case,
                           make_kv_len_case, make_spmm_bwd_case, make_spmm_case,
                           padding_rows)
from serve_batch_cases import BINDING as SERVE_BINDING
from serve_batch_cases import CASES as SERVE_CASES
from serve_batch_cases import MASKS as SERVE_MASKS
from serve_batch_cases import make_case as make_serve_case
from serve_batch_cases import numpy_codes as numpy_serve_codes
import tier_slab_cases as tsc
from mesh_ranks import one_rank_mesh
from repro_torch.core.api import build_oracle
from repro_torch.graph.generators import paper_dataset_analogue
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rows(rng, n, L, sorted_prefix):
    m = rng.integers(0, 400, size=(n, L)).astype(np.int32)
    if sorted_prefix:
        m.sort(axis=1)
        m[np.arange(L)[None, :] >= rng.integers(0, L + 1, size=n)[:, None]] = -1
    else:
        m[rng.random((n, L)) < 0.3] = -1
    return m


@pytest.mark.parametrize("sorted_prefix", [True, False])
@pytest.mark.parametrize("Lo,Li", [(16, 8), (128, 40)])
def test_tier_intersect_kernel_matches_plain(cuda, rng, Lo, Li, sorted_prefix):
    n = 3000
    L_out = torch.from_numpy(_rows(rng, n, Lo, sorted_prefix)).to(cuda)
    L_in = torch.from_numpy(_rows(rng, n, Li, sorted_prefix)).to(cuda)
    for B in (1, 4099):
        q = rng.integers(0, n, (B, 2)).astype(np.int32)
        q[-1] = (n - 1, n - 1)
        q = torch.from_numpy(q).to(cuda)
        for width in (8, 16, 24, 128):
            before = ops.LAUNCHES["label_intersect"]
            got = ops.tier_intersect(L_out, L_in, q, width)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["label_intersect"] == before + 1
            assert got.dtype == torch.bool and got.device.type == "cuda"
            assert torch.equal(got, ref.tier_intersect_ref(L_out, L_in, q, width))


@pytest.mark.parametrize("B,La,Lb", [(7, 8, 8), (64, 24, 16), (300, 64, 48), (1, 128, 128)])
def test_label_intersect_kernel_matches_plain(cuda, rng, B, La, Lb):
    a = torch.from_numpy(_rows(rng, B, La, False)).to(cuda)
    b = torch.from_numpy(_rows(rng, B, Lb, False)).to(cuda)
    ident = lambda k: torch.arange(k, dtype=torch.int32, device=cuda)[:, None].repeat(1, 2)  # noqa: E731
    got = ops.tier_intersect(a, b, ident(B).contiguous(), max(La, Lb))
    torch.cuda.synchronize()
    assert torch.equal(got, ref.label_intersect_ref(a, b))
    pad = torch.full((16, 8), -1, dtype=torch.int32, device=cuda)
    assert not ops.tier_intersect(pad, pad, ident(16).contiguous(), 8).any()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("layout", tsc.TIER_LAYOUTS)
@pytest.mark.parametrize("Lo,Li", tsc.TIER_SHAPES)
def test_tier_intersect_kernel_edges(cuda, rng, Lo, Li, layout, aligned):
    """The one-entry-a-lane loop (widths not a multiple of 4, a base 4 bytes
    into its buffer) beside the 16-byte one, INVALID before valid values, a
    width above both matrices, B off every block size; unaligned, the
    queries also start 4 bytes into their buffer (the two-word id read)."""
    n = tsc.TIER_N
    L_out = torch.from_numpy(tsc.tier_rows(rng, n, Lo, layout)).to(cuda)
    L_in = torch.from_numpy(tsc.tier_rows(rng, n, Li, layout)).to(cuda)
    if not aligned:
        L_out, L_in = tsc.unaligned(L_out), tsc.unaligned(L_in)
        assert L_out.data_ptr() % 16 and L_out.is_contiguous()
    for B in tsc.TIER_BATCHES:
        q = torch.from_numpy(tsc.tier_queries(rng, n, B)).to(cuda)
        if not aligned:
            q = tsc.unaligned(q)
            assert q.data_ptr() % 8 and q.is_contiguous()
        for width in tsc.TIER_WIDTHS:
            before = ops.LAUNCHES["label_intersect"]
            got = ops.tier_intersect(L_out, L_in, q, width)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["label_intersect"] == before + 1
            assert torch.equal(got, ref.tier_intersect_ref(L_out, L_in, q, width)), (B, width)


@pytest.mark.parametrize("Lo,Li", tsc.TIER_SHAPES)
def test_tier_intersect_kernel_bad_ids_answer_false(cuda, rng, Lo, Li):
    """Ids -1, n and 2**31 - 1 read no memory and answer false; the other
    queries of the batch are answered as the plain version answers them."""
    n = tsc.TIER_N
    L_out = torch.from_numpy(tsc.tier_rows(rng, n, Lo, "holes")).to(cuda)
    L_in = torch.from_numpy(tsc.tier_rows(rng, n, Li, "holes")).to(cuda)
    q, bad = tsc.bad_id_queries(rng, n, 4099)
    got = ops.tier_intersect(L_out, L_in, torch.from_numpy(q).to(cuda), 16)
    torch.cuda.synchronize()
    exp = ref.tier_intersect_ref(L_out, L_in, torch.from_numpy(q[~bad]).to(cuda), 16)
    assert not got[torch.from_numpy(bad).to(cuda)].any()
    assert torch.equal(got[torch.from_numpy(~bad).to(cuda)], exp)


def test_main_path_serves_through_the_kernel(cuda):
    g = paper_dataset_analogue("citeseer", scale=0.01)
    co = build_oracle(g)
    assert co.engine.backend == "kernel"
    q = np.random.default_rng(0).integers(0, g.n, (8192, 2)).astype(np.int32)
    ops.reset_launches()
    got = co.serve(q)
    # one serve_batch launch for the one non-empty batch; the tier form none
    assert ops.LAUNCHES["serve_batch"] == 1
    assert ops.LAUNCHES["label_intersect"] == 0
    assert (got == co.serve(q, backend="host")).all()
    assert not any(co.engine.degradation.values())


# ------------------------------------------------------- K1's batch form


@pytest.mark.parametrize("name", SERVE_CASES)
def test_serve_batch_kernel_matches_plain(cuda, name):
    """The kernel against its plain version on the edge cases of
    tests/serve_batch_cases.py (the ``mask_`` ones under a budget), code byte
    for code byte; a bad id raises."""
    case = make_serve_case(np.random.default_rng(SERVE_CASES.index(name)), name)
    args = [None if case[k] is None else torch.from_numpy(case[k]).to(cuda)
            for k in SERVE_BINDING] + [case["widths"]]
    masks = {k: None if case[k] is None else torch.from_numpy(case[k]).to(cuda)
             for k in SERVE_MASKS}
    sb = ops.ServeBatch(*args, **masks)
    q = case["queries"]
    before = ops.LAUNCHES["serve_batch"]
    if name.startswith("bad_"):
        with pytest.raises(IndexError, match="outside"):
            sb(q)
        assert ops.LAUNCHES["serve_batch"] == before + 1
        good = q[q.min(1) >= 0] % args[0].shape[0]   # the flag clears after a raise
        assert (sb(good) == ref.serve_batch_ref(*args, torch.from_numpy(good).to(cuda))
                .cpu().numpy()).all()
        return
    got = sb(q)
    assert ops.LAUNCHES["serve_batch"] == before + int(q.shape[0] > 0)
    exp = ref.serve_batch_ref(*args, torch.from_numpy(q).to(cuda), **masks).cpu().numpy()
    assert got.dtype == np.uint8 and (got == exp).all(), int((got != exp).sum())
    assert (got == numpy_serve_codes(case)).all()


def _truth(g, q):
    from repro_torch.graph.reach import reachable_set

    return np.array([u == v or bool(reachable_set(g, int(u))[v]) for u, v in q])


@pytest.mark.parametrize("frac", [0.25, 0.5, 0.75])
@pytest.mark.parametrize("family", range(5))
def test_budgeted_kernel_engine_on_the_card(cuda, family, frac):
    """Under a budget the kernel engine marks the uncertain queries in
    serve_batch (one launch a batch) and searches exactly those: verdicts
    and counters as the host backend's numpy epilogue, verdicts as BFS
    truth, marks as the plain version's with the same masks."""
    from repro_torch.serve.budget import label_bytes, truncate_store

    name, g = _dag_families()[family]
    co = build_oracle(g)
    st = truncate_store(co.oracle, budget_bytes=int(label_bytes(co.oracle) * frac))
    co.engine.set_budget(st)
    q = np.random.default_rng(family).integers(0, g.n, (1500, 2)).astype(np.int32)
    ops.reset_launches()
    got = co.serve(q)
    assert ops.LAUNCHES["serve_batch"] == 1 and co.engine.last_stats["backend"] == "kernel"
    kern = dict(co.engine.last_stats["degraded"])
    assert (got == co.serve(q, backend="host")).all() and (got == _truth(g, q)).all()
    assert co.engine.last_stats["degraded"] == kern
    assert kern["searched"] == kern["uncertain"]
    sb = co.engine._budget_view.serve_batch
    cq = np.ascontiguousarray(co.comp[q], dtype=np.int32)
    codes = sb(cq)
    exp = ref.serve_batch_ref(sb.L_out, sb.L_in, sb.out_len, sb.in_len, sb.level, sb.widths,
                              torch.from_numpy(cq).to(cuda), sb.trunc_out, sb.trunc_in)
    assert (codes == exp.cpu().numpy()).all()
    assert int((codes & ops.SERVE_BATCH_UNCERTAIN != 0).sum()) == kern["uncertain"]
    co.engine.set_budget(None)


@pytest.mark.parametrize("family", range(5))
def test_hierarchical_served_through_serve_batch(cuda, family):
    """Hierarchical-Labeling (vertex-id labels, 16/16 wide at full size)
    served on the card: one serve_batch launch, its codes equal to the plain
    version's on the same binding, verdicts equal to the host merge and BFS
    truth, no degradation."""
    name, g = _dag_families()[family]
    co = build_oracle(g, method="hierarchical", core_max=16)
    assert co.oracle.hop_rank is None and co.engine.backend == "kernel"
    q = np.random.default_rng(family).integers(0, g.n, (1500, 2)).astype(np.int32)
    ops.reset_launches()
    got = co.serve(q)
    assert ops.LAUNCHES["serve_batch"] == 1 and ops.LAUNCHES["label_intersect"] == 0
    assert (got == co.serve(q, backend="host")).all() and (got == _truth(g, q)).all()
    assert not any(co.engine.degradation.values())
    sb = co.engine._serve_batch_op()
    cq = np.ascontiguousarray(co.comp[q], dtype=np.int32)
    exp = ref.serve_batch_ref(sb.L_out, sb.L_in, sb.out_len, sb.in_len, sb.level, sb.widths,
                              torch.from_numpy(cq).to(cuda))
    assert (sb(cq) == exp.cpu().numpy()).all()


def test_daemon_round_trip_on_the_card(cuda):
    """One open-loop daemon run on the card: every device dispatch is one
    serve_batch launch, answers exact, the registry equal to the books."""
    from repro_torch.obs import metrics
    from repro_torch.serve.openloop import run_open_loop

    g = paper_dataset_analogue("citeseer", scale=0.02)
    co = build_oracle(g)
    metrics.REGISTRY.reset()
    ops.reset_launches()
    rep = run_open_loop(co, g, rate_arrivals_per_s=200.0, duration_s=0.5,
                        deadline_ms=5000.0, seed=1, n_truth=200)
    assert rep["sample_errors"] == 0 and rep["answered"] == rep["submitted"] > 0
    assert rep["device_batches"] == rep["batches"] and not any(rep["degradation"].values())
    # the seven warm-up rungs (64 .. 4,096), then one launch a dispatch
    assert ops.LAUNCHES["serve_batch"] == 7 + rep["device_batches"]
    assert metrics.REGISTRY.counter_value("daemon_requests_total", event="answered") == \
        rep["answered"]


@pytest.mark.parametrize("mode", ["strict", "quarantine"])
@pytest.mark.parametrize("family", range(5))
def test_cold_started_kernel_engine_on_the_card(cuda, family, mode, tmp_path):
    """oracle_from_snapshot on the card: the built oracle's labels, its
    verdicts through serve_batch; with a corrupt row block, quarantine mode
    answers the corrupt rows through exact search."""
    from repro_torch.core.api import oracle_from_snapshot
    from repro_torch.ft.inject import flip_bit
    from repro_torch.persist import save_oracle

    name, g = _dag_families()[family]
    built = build_oracle(g)
    path = save_oracle(str(tmp_path / "snap"), built.oracle, row_block=16)
    rng = np.random.default_rng(family)
    q = rng.integers(0, g.n, (1500, 2)).astype(np.int32)
    if mode == "quarantine":
        k = (built.oracle.n - 1) // 16   # the last row block
        rows = np.arange(16 * k, built.oracle.n)
        flip_bit(str(tmp_path / "snap" / f"L_out.{k:05d}.npy"), seed=family)
        with pytest.warns(UserWarning):
            co = oracle_from_snapshot(g, path, mode=mode)
        assert co.engine.stats()["n_quarantined"] == rows.size
        q[:64, 0] = rng.choice(np.flatnonzero(np.isin(co.comp, rows)), 64)
    else:
        co = oracle_from_snapshot(g, path)
        _assert_same_labels(built.oracle, co.oracle, name)
    assert co.engine.backend == "kernel" and co.engine.device.type == "cuda"
    ops.reset_launches()
    got = co.serve(q)
    # one launch for the batch, unless the quarantine takes every query
    # (the cyclic family's condensation is one block)
    labelled = co.engine.quarantine_out is None or \
        (~co.engine.quarantine_out[co.comp[q[:, 0]]]).any()
    assert ops.LAUNCHES["serve_batch"] == int(labelled)
    assert (got == built.serve(q, backend="host")).all() and (got == _truth(g, q)).all()
    deg = co.engine.stats()["degradation"]
    if mode == "quarantine":
        assert deg["quarantined"] >= 64 and deg["searched"] == deg["quarantined"]
    else:
        assert not any(deg.values())


# ------------------------------------------------------------ K2 frontier_or


def _frontier_case(rng, r, d, n_src, wm, edge):
    nbr = rng.integers(0, n_src, size=(r, d)).astype(np.int32)
    nbr[rng.random((r, d)) < 0.35] = -1
    f = rng.integers(0, 2**32, size=(n_src, wm), dtype=np.uint32)
    if edge == "all_invalid":
        nbr[: max(r // 2, 1)] = -1
    elif edge == "last_id":
        nbr[:, 0] = n_src - 1
    elif edge == "bit31":
        f |= np.uint32(1 << 31)
    return nbr, f.view(np.int32)


def _frontier_or_both_forms(nbr, f, perm, out0):
    """The kernel and the plain version in both forms, then a second fused
    pass of the kernel over its own result, which must add no bit."""
    assert torch.equal(ops.frontier_or(nbr, f), ref.frontier_or_ref(nbr, f))
    outs, flags = [], []
    for fn in (ops.frontier_or, ref.frontier_or_ref):
        out, fl = out0.clone(), torch.zeros(2, dtype=torch.int32, device=f.device)
        fn(nbr, f, out=out, perm=perm, flags=fl)
        outs.append(out)
        flags.append(fl)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(flags[0], flags[1])
    fl = torch.zeros(2, dtype=torch.int32, device=f.device)
    ops.frontier_or(nbr, f, out=outs[0], perm=perm, flags=fl)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and fl.tolist() == [0, 0]


@pytest.mark.parametrize("edge", [None, "all_invalid", "last_id", "bit31"])
@pytest.mark.parametrize("r,d,n_src,wm", [(13, 4, 50, 1), (128, 16, 200, 2), (1, 7, 9, 3),
                                          (1, 16, 40, 8), (5000, 16, 9000, 8)])
def test_frontier_or_kernel_matches_plain(cuda, rng, r, d, n_src, wm, edge):
    nbr_np, f_np = _frontier_case(rng, r, d, n_src, wm, edge)
    nbr, f = torch.from_numpy(nbr_np).to(cuda), torch.from_numpy(f_np).to(cuda)
    before = ops.LAUNCHES["frontier_or"]
    got = ops.frontier_or(nbr, f)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["frontier_or"] == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    # the fused form: OR into permuted rows of a running output, with flags
    n_out = r + 7
    perm = torch.from_numpy(rng.permutation(n_out)[:r].astype(np.int64)).to(cuda)
    out0 = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n_out, wm),
                                         dtype=np.int64).astype(np.int32)).to(cuda)
    _frontier_or_both_forms(nbr, f, perm, out0)


@pytest.mark.parametrize("d", tsc.SLAB_D)
@pytest.mark.parametrize("wm", tsc.SLAB_WM)
def test_frontier_or_kernel_edges(cuda, rng, wm, d):
    """Every wm of 1, 3, 8, 9, 32 (one word a thread, or four) with every d
    of 1, 7, 16, 20, 32, 33 (ids 16 slots at a time, in one chunk or more)."""
    r, n_src = tsc.SLAB_R, tsc.SLAB_N_SRC
    nbr, f = tsc.slab_case(rng, r, d, n_src, wm)
    perm, out0 = tsc.fused_case(rng, r, wm)
    to = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    _frontier_or_both_forms(to(nbr), to(f.view(np.int32)), to(perm), to(out0.view(np.int32)))


def test_frontier_or_kernel_unaligned(cuda, rng):
    """A slab and f 4 bytes into their buffers: the one-word loop with ids
    read 4 bytes at a time."""
    r, n_src = tsc.SLAB_R, tsc.SLAB_N_SRC
    nbr, f = tsc.slab_case(rng, r, 16, n_src, 8)
    perm, out0 = tsc.fused_case(rng, r, 8)
    to = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    nbr, f = tsc.unaligned(to(nbr)), tsc.unaligned(to(f.view(np.int32)))
    assert nbr.data_ptr() % 16 and f.data_ptr() % 16
    _frontier_or_both_forms(nbr, f, to(perm), to(out0.view(np.int32)))


@pytest.mark.parametrize("wm,d", [(8, 16), (3, 7)])
def test_frontier_or_kernel_fused_skips_bad_ids(cuda, rng, wm, d):
    """Ids n_src and -2 and a perm entry n_out: skipped and flagged in
    flags[1] in the fused form, as the plain version does."""
    nbr, f, perm, out0 = tsc.bad_slab(rng, tsc.SLAB_R, d, tsc.SLAB_N_SRC, wm)
    nbr, f, perm, out0 = (torch.from_numpy(x).to(cuda)
                          for x in (nbr, f.view(np.int32), perm, out0.view(np.int32)))
    outs, flags = [], []
    for fn in (ops.frontier_or, ref.frontier_or_ref):
        out, fl = out0.clone(), torch.zeros(2, dtype=torch.int32, device=cuda)
        fn(nbr, f, out=out, perm=perm, flags=fl)
        outs.append(out)
        flags.append(fl)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(flags[0], flags[1])
    assert flags[0].tolist()[1] == 1


def test_frontier_or_kernel_refuses_bad_ids(cuda):
    f = torch.zeros((6, 2), dtype=torch.int32, device=cuda)
    for bad in (6, -2):
        nbr = torch.tensor([[0, bad]], dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="outside"):
            ops.frontier_or(nbr, f)


# ------------------------------------------------ K2 frontier_expand


@pytest.mark.parametrize("name", CASES)
def test_frontier_expand_kernel_matches_plain(cuda, name):
    """The kernel against its plain version on one level's edge cases
    (tests/frontier_cases.py): words, stamps and counts exactly, the ring's
    and the cone's new entries as sets."""
    case = make_case(np.random.default_rng(CASES.index(name)), name)
    res = []
    for fn in (ops.frontier_expand, ref.frontier_expand_ref):
        t = {k: (torch.from_numpy(case[k].copy()).to(cuda) if k in ARRAYS else case[k])
             for k in ORDER}
        before = ops.LAUNCHES["frontier_expand"]
        fn(*(t[k] for k in ORDER))
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["frontier_expand"] - before
        assert launched == int(fn is ops.frontier_expand and case["hi"] > case["lo"]), name
        res.append({k: (t[k].cpu().numpy() if k in ARRAYS else t[k]) for k in ORDER})
    assert_same_level(case, res[0], res[1], name)
    assert int(res[0]["counts"][2]) == int(name.startswith("bad_")), name


def _dag_families():
    """The five construction families of tests/test_build_engine.py, made
    with the port's generators (equal graphs for equal seeds)."""
    from repro_torch.graph.csr import from_edges
    from repro_torch.graph.generators import layered_dag, random_dag, tree_dag
    from repro_torch.graph.scc import condense_to_dag

    rng = np.random.default_rng(0)
    fams = [("random_dag", random_dag(70, 200, seed=1)),
            ("layered_dag", layered_dag(80, avg_out=2.5, seed=2)),
            ("tree_dag", tree_dag(90, branching=4, seed=3))]
    src, dst = rng.integers(0, 60, 170), rng.integers(0, 60, 170)
    fams.append(("cyclic", condense_to_dag(from_edges(60, src, dst))[0]))
    src, dst = rng.integers(0, 40, 60), rng.integers(0, 40, 60)
    fams.append(("isolated", condense_to_dag(from_edges(80, src, dst))[0]))
    return fams


def _assert_same_labels(a, b, tag):
    for f in ("L_out", "L_in", "out_len", "in_len", "hop_rank"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), (tag, f)


@pytest.mark.parametrize("family", range(5))
def test_device_build_on_the_card(cuda, family):
    name, g = _dag_families()[family]
    ref_co = build_oracle(g, impl="reference")
    ops.reset_launches()
    dev_co = build_oracle(g, impl="device")
    assert ops.LAUNCHES["frontier_expand"] > 0 and ops.LAUNCHES["frontier_or"] == 0
    st = dev_co.oracle.build_stats["device"]
    assert st["device"].startswith("cuda")
    assert ops.LAUNCHES["frontier_expand"] == st["levels"]
    assert st["host_reads"] == st["levels"] + st["sweeps"]
    _assert_same_labels(ref_co.oracle, dev_co.oracle, name)
    # prune_cap (JAX's dense-prune switch) changes nothing in the frontier form
    _assert_same_labels(ref_co.oracle, build_oracle(g, impl="device", prune_cap=1).oracle,
                        f"{name} prune_cap=1")


def test_device_build_label_growth_on_the_card(cuda):
    from repro_torch.graph.generators import random_dag

    g = random_dag(60, 170, seed=7)
    ref_co = build_oracle(g, impl="reference")
    ops.reset_launches()
    dev_co = build_oracle(g, impl="device", max_wave=16, l_max=2)
    assert ops.LAUNCHES["frontier_expand"] > 0 and ops.LAUNCHES["frontier_or"] == 0
    assert dev_co.oracle.build_stats["device"]["regrows"] > 0
    _assert_same_labels(ref_co.oracle, dev_co.oracle, "l_max growth")


# ------------------------------------------------------ multi-device modes


def test_sharded_engine_one_rank_nccl(cuda):
    """Both sharded backends over a one-rank NCCL mesh: K1's tier form once
    a batch a backend, the host merge's verdicts, no degradation."""
    g = paper_dataset_analogue("citeseer", scale=0.01)
    q = np.random.default_rng(0).integers(0, g.n, (3 * 4096, 2)).astype(np.int32)
    with one_rank_mesh("nccl") as mesh:
        co = build_oracle(g, mesh=mesh)
        assert co.engine.backend == "sharded"
        exp = co.serve(q, backend="host")
        for be in ("sharded", "sharded_hop"):
            ops.reset_launches()
            got = np.concatenate([co.serve(q[i:i + 4096], backend=be)
                                  for i in range(0, q.shape[0], 4096)])
            assert ops.LAUNCHES["label_intersect"] == 3 and ops.LAUNCHES["serve_batch"] == 0
            assert (got == exp).all(), be
        assert not any(co.engine.degradation.values())


@pytest.mark.parametrize("family", range(5))
def test_mesh_build_one_rank_nccl(cuda, family):
    """The ``mesh=`` device build over a one-rank NCCL mesh: K2's slab form
    once a slab call, one collective a level, the reference's labels."""
    from repro_torch.build.engine import build_distribution_labels

    name, g = _dag_families()[family]
    ref_o = build_distribution_labels(g, impl="reference")
    with one_rank_mesh("nccl") as mesh:
        ops.reset_launches()
        o = build_distribution_labels(g, impl="device", mesh=mesh)
    st = o.build_stats["device"]
    assert ops.LAUNCHES["frontier_or"] == st["slab_calls"] > 0
    assert ops.LAUNCHES["frontier_expand"] == 0
    assert st["collectives"] == st["levels"] > 0
    _assert_same_labels(ref_o, o, name)


# --------------------------------------------------------- dynamic oracle


def _raw_families():
    """The five serve-test families (tests/test_serve_engine.py), cycles and
    isolated vertices kept, made with the port's generators."""
    from repro_torch.graph.csr import from_edges
    from repro_torch.graph.generators import layered_dag, random_dag, tree_dag

    rng = np.random.default_rng(0)
    fams = [("random_dag", random_dag(70, 200, seed=1)),
            ("layered_dag", layered_dag(80, avg_out=2.5, seed=2)),
            ("tree_dag", tree_dag(90, branching=4, seed=3))]
    src, dst = rng.integers(0, 60, 170), rng.integers(0, 60, 170)
    fams.append(("cyclic", from_edges(60, src, dst)))
    src, dst = rng.integers(0, 40, 60), rng.integers(0, 40, 60)
    fams.append(("isolated", from_edges(80, src, dst)))
    return fams


def _truth_adj(adj, q):
    """BFS truth over adjacency sets (the dynamic oracle's live edge log)."""
    out = np.empty(q.shape[0], dtype=bool)
    for i, (u, v) in enumerate(q):
        seen, stack = {int(u)}, [int(u)]
        while stack and int(v) not in seen:
            for w in adj[stack.pop()]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        out[i] = int(v) in seen
    return out


def _repair_updates(dyn, rng, k=12):
    """DAG-preserving updates: inserts oriented by the condensation's levels,
    deletes of edges between two SCCs."""
    comp, lvl = dyn.delta.comp, dyn.level
    ups = []
    for _ in range(k):
        a, b = (int(x) for x in rng.integers(0, comp.size, 2))
        if lvl[comp[a]] != lvl[comp[b]]:
            ups.append((a, b) if lvl[comp[a]] < lvl[comp[b]] else (b, a))
    cross = [(u, w) for u in range(comp.size) for w in sorted(dyn.delta.out_adj[u])
             if comp[u] != comp[w]]
    dels = [cross[int(i)] for i in rng.integers(0, len(cross), 4)] if cross else []
    return ups, dels


@pytest.mark.parametrize("publish", ["repair", "structural"])
@pytest.mark.parametrize("family", range(5))
def test_dynamic_oracle_on_the_card(cuda, family, publish):
    """A DynamicOracle on the card after a repair publish or a structural
    (SCC merge -> compacting rebuild) publish: the current epoch through
    serve_batch (one launch), the pinned epoch before it through K1's tier
    form label_intersect (one launch), each equal to its plain version, to
    the host merge and to BFS truth of its own graph."""
    from repro_torch.dynamic import DynamicOracle, UpdateBatch
    from repro_torch.serve.prefilter import apply_prefilters

    name, g = _raw_families()[family]
    rng = np.random.default_rng(family)
    dyn = DynamicOracle(g)
    assert dyn.engine.backend == "kernel" and dyn.snapshot().device.type == "cuda"
    q = rng.integers(0, g.n, (1500, 2)).astype(np.int32)
    adj0 = [set(s) for s in dyn.delta.out_adj]
    if publish == "repair":
        ins, dels = _repair_updates(dyn, rng)
    else:
        comp = dyn.delta.comp
        a, b = next((u, w) for u in range(g.n) for w in sorted(dyn.delta.out_adj[u])
                    if comp[u] != comp[w])
        ins, dels = [(b, a)], []   # closes a cycle: a merge
    st = dyn.apply(UpdateBatch.of(ins, dels))
    assert (st.structural > 0) == (publish == "structural") and st.rebuild_pending == \
        (publish == "structural"), st
    e1 = dyn.publish()
    assert dyn.growth_log[-1]["rebuilt"] == (publish == "structural")
    # the current epoch: K1's batch form
    ops.reset_launches()
    cur = dyn.serve(q)
    assert ops.LAUNCHES["serve_batch"] == 1 and ops.LAUNCHES["label_intersect"] == 0
    assert (cur == dyn.serve(q, backend="dense")).all()
    assert (cur == dyn.serve(q, backend="host")).all()
    assert (cur == _truth_adj(dyn.delta.out_adj, q)).all()
    # the pinned epoch: K1's tier form
    snap = dyn.snapshot(e1 - 1)
    cq = snap.comp[q]
    o = snap.oracle
    rest = ~apply_prefilters(cq, o.out_len, o.in_len, snap.level).decided
    ops.reset_launches()
    old = dyn.serve(q, epoch=e1 - 1)
    assert ops.LAUNCHES["label_intersect"] == int(rest.any())
    assert ops.LAUNCHES["serve_batch"] == 0
    assert (old == snap.query_batch(q, device=False)).all()
    assert (old == _truth_adj(adj0, q)).all()
    lo, li = o.device_labels(cuda)
    width = max(lo.shape[1], li.shape[1])
    qd = torch.from_numpy(np.ascontiguousarray(cq[rest], dtype=np.int32)).to(cuda)
    assert torch.equal(ops.tier_intersect(lo, li, qd, width),
                       ref.tier_intersect_ref(lo, li, qd, width))
    assert not any(dyn.engine.degradation.values())


def test_durable_crash_and_recovery_on_the_card(cuda, tmp_path):
    """A durable oracle on the card: published batches, an acknowledged tail
    never published, a crash; the recovery on the card serves the
    never-crashed oracle's verdicts through serve_batch."""
    from repro_torch.dynamic import DurableDynamicOracle, DynamicOracle, UpdateBatch

    g = paper_dataset_analogue("citeseer", scale=0.02)
    rng = np.random.default_rng(3)
    ref_dyn = DynamicOracle(g)
    dur = DurableDynamicOracle(g, state_dir=str(tmp_path))
    batches = []
    for _ in range(3):
        ins, dels = _repair_updates(ref_dyn, rng, k=40)
        batches.append(UpdateBatch.of(ins, dels))
        ref_dyn.apply(batches[-1])
    for b in batches[:2]:
        dur.apply(b)
        dur.publish()
    dur.apply(batches[2])
    del dur
    ref_dyn.publish()
    rec = DurableDynamicOracle.recover(str(tmp_path))
    assert rec.recovered_records > 0 and rec.engine.device.type == "cuda"
    q = rng.integers(0, g.n, (4096, 2)).astype(np.int32)
    ops.reset_launches()
    got = rec.serve(q)
    assert ops.LAUNCHES["serve_batch"] == 1
    assert (got == ref_dyn.serve(q)).all()
    assert (got[:500] == _truth_adj(rec.delta.out_adj, q[:500])).all()


@pytest.mark.parametrize("scenario", ["build", "corrupt", "serve", "dynamic", "daemon",
                                      "budget"])
def test_chaos_scenarios_on_the_card(cuda, scenario):
    from repro_torch.launch import chaos

    assert chaos.SCENARIOS[scenario](0, cuda)


# ------------------------------------------------------------ kernel library


def _launched(name, fn):
    """fn() through the wrapper, which must count exactly one launch."""
    before = ops.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1, name
    return out


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32).view(np.int32)


@pytest.mark.parametrize("n,k,m", [(16, 32, 32), (70, 90, 100), (128, 256, 64), (1, 90, 8),
                                   (1024, 1024, 1024), (300, 70, 9000)])
def test_bitset_mm_kernel_matches_plain(cuda, rng, n, k, m):
    wk, wm = (k + 31) // 32, (m + 31) // 32
    a = torch.from_numpy(_u32(rng, (n, wk))).to(cuda)
    x = torch.from_numpy(_u32(rng, (k, wm))).to(cuda)
    got = _launched("bitset_mm", lambda: ops.bitset_mm(a, x))
    assert got.dtype == torch.int32 and got.shape == (n, wm)
    assert torch.equal(got, ref.bitset_mm_ref(a, x))
    # sparse rows, bit 31 in every word, rows with no bit
    sparse = torch.from_numpy(np.where(rng.random((n, wk)) < 0.2, _u32(rng, (n, wk)) | -2**31,
                                       0).astype(np.int32)).to(cuda)
    got = _launched("bitset_mm", lambda: ops.bitset_mm(sparse, x))
    assert torch.equal(got, ref.bitset_mm_ref(sparse, x))


@pytest.mark.parametrize("case", BITSET_CASES, ids=case_id)
def test_bitset_mm_kernel_edges(cuda, rng, case):
    a, x = (torch.from_numpy(v).to(cuda) for v in make_bitset_case(rng, *case))
    got = _launched("bitset_mm", lambda: ops.bitset_mm(a, x))
    assert torch.equal(got, ref.bitset_mm_ref(a, x))


def test_bitset_mm_kernel_closure(cuda):
    from repro_torch.graph.reach import adjacency_bits, transitive_closure_bits

    g = paper_dataset_analogue("reactome", 1.0)
    R = torch.from_numpy(adjacency_bits(g).view(np.int32)).to(cuda)
    for _ in range(g.n.bit_length() + 2):
        new = R | ops.bitset_mm(R, R)
        if torch.equal(new, R):
            break
        R = new
    assert (R.cpu().numpy().view(np.uint32) == transitive_closure_bits(g)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,Hq,Hkv,S,T,D,causal,window",
    [
        (1, 2, 2, 128, 128, 32, True, None),
        (2, 4, 2, 256, 256, 64, True, None),
        (1, 4, 1, 128, 128, 64, True, 48),
        (2, 2, 2, 1, 256, 32, True, None),
        (1, 2, 2, 128, 256, 32, True, None),
        (1, 2, 2, 128, 128, 32, False, None),
        (1, 2, 1, 192, 64, 32, True, None),       # S > T: zero rows
        (1, 4, 2, 130, 97, 80, True, 40),          # D = 80, ragged S and T, window < S
        (1, 2, 2, 64, 100, 128, False, 24),        # window without causal, D = 128
        (3, 32, 8, 1, 1000, 64, True, None),       # decode, GQA 4
        (1, 8, 2, 1024, 1024, 64, True, None),     # kernel_bench's shape
        (1, 4, 4, 5, 300, 8, True, 0),             # window 0: no key at all
        # the bfloat16 kernel's tile edges: 64-row query tiles of rep * S packed
        # rows and 64-key tiles; S and T off the tiles, windows one key either
        # side of a tile boundary, rep 1, 4 and 8, D from 8 to 128 (padded to
        # 16, 32, 64, 80, 96 or 128), decode with a ragged last key tile, S > T
        (1, 4, 4, 100, 100, 64, True, None),       # rep 1, ragged S and T
        (1, 2, 2, 256, 256, 64, True, 63),         # window one key inside a tile
        (1, 2, 2, 256, 256, 64, True, 64),         # window on a tile boundary
        (1, 2, 2, 256, 256, 64, True, 65),         # window one key past it
        (1, 2, 2, 128, 192, 32, False, 64),        # window without causal, T > S
        (1, 8, 1, 77, 200, 64, True, None),        # rep 8
        (2, 8, 2, 33, 129, 8, True, None),         # rep 4, D = 8, T one past a tile
        (1, 4, 2, 70, 130, 24, False, 33),         # D = 24
        (1, 4, 2, 70, 127, 80, True, 65),          # D = 80, T one short of a tile
        (1, 4, 1, 50, 190, 128, True, None),       # D = 128
        (2, 32, 8, 1, 777, 64, True, None),        # decode, ragged last key tile
        (2, 32, 8, 1, 4097, 128, True, 1000),      # decode, window, D = 128
        (1, 4, 2, 150, 70, 24, True, None),        # S > T: the first 80 rows see nothing
        (1, 4, 2, 40, 20, 8, True, None),          # T under one key tile, S > T
        (1, 4, 2, 70, 100, 40, True, None),        # D = 40: columns 40-63 zero-filled
        (1, 2, 1, 64, 90, 72, False, None),        # D = 72: a 16-column second chunk
        (1, 4, 2, 64, 64, 96, True, None),         # D = 96: a 32-column second chunk
        (1, 2, 2, 65, 65, 112, True, 30),          # D = 112
    ],
)
def test_flash_attention_kernel_matches_plain(cuda, rng, B, Hq, Hkv, S, T, D, causal, window,
                                              dtype):
    q = torch.from_numpy(rng.standard_normal((B, Hq, S, D)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(rng.standard_normal((B, Hkv, T, D)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.standard_normal((B, Hkv, T, D)).astype(np.float32)).to(cuda)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = _launched(ops.attention_kernel(dtype),
                    lambda: ops.flash_attention(q, k, v, causal=causal, window=window))
    assert got.dtype == dtype and got.shape == (B, Hq, S, D)
    # the plain version in float32 on the same (rounded) inputs, its result
    # rounded as the kernel's is: bfloat16 outputs may differ by one step
    exp = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                  window=window)
    if dtype == torch.float32:
        torch.testing.assert_close(got, exp, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), exp.to(dtype).float(), rtol=2**-7, atol=1e-4)
    if causal and S > T:
        assert not got[:, :, : S - T].any()   # qpos < 0: no key, zero rows


@pytest.mark.parametrize("case", ATTENTION_F32_CASES, ids=case_id)
def test_flash_attention_f32_kernel_edges(cuda, rng, case):
    """float32 at the edges of the tiled kernel: rows a (batch, kv head)
    under, at and over one 64-row tile, S and T off the tiles, D = 8, 72 and
    128, rep 1, 4 and 8, no mask, windows under one tile, rows that see no
    key, decode."""
    B, Hq, Hkv, S, T, D, causal, window = case
    q = torch.from_numpy(rng.standard_normal((B, Hq, S, D)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(rng.standard_normal((B, Hkv, T, D)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.standard_normal((B, Hkv, T, D)).astype(np.float32)).to(cuda)
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, causal=causal, window=window))
    exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, exp, rtol=2e-5, atol=2e-5)
    if causal and S > T:
        assert not got[:, :, : S - T].any()
    if window == 0:
        assert not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", KV_LEN_CASES, ids=case_id)
def test_flash_attention_kv_len_matches_plain(cuda, rng, case, dtype):
    """Both K4 kernels over a preallocated cache: only the first kv_len keys
    exist (NaN past them would reach the output if read), the queries
    right-aligned to them."""
    B, Hq, Hkv, S, T, kv_len, D, window = case
    q, k, v = (torch.from_numpy(x).to(cuda).to(dtype)
               for x in make_kv_len_case(rng, B, Hq, Hkv, S, T, kv_len, D))
    got = _launched(ops.attention_kernel(dtype), lambda: ops.flash_attention(
        q, k, v, causal=True, window=window, kv_len=kv_len))
    assert torch.isfinite(got).all()
    exp = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True, window=window,
                                  kv_len=kv_len)
    if dtype == torch.float32:
        torch.testing.assert_close(got, exp, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), exp.to(dtype).float(), rtol=2**-7, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTENTION_DV_CASES, ids=case_id)
def test_flash_attention_value_width_matches_plain(cuda, rng, case, dtype):
    """Both K4 kernels with a value width of its own (MLA's prefill, D = 192
    and Dv = 128, and the edges of ``ATTENTION_DV_CASES``), also over a
    preallocated cache with NaN past kv_len: [B, Hq, S, Dv] out."""
    B, Hq, Hkv, S, T, kv_len, D, Dv, causal, window = case
    q, k, v = (torch.from_numpy(x).to(cuda).to(dtype)
               for x in make_kv_len_case(rng, B, Hq, Hkv, S, T, kv_len or T, D, Dv))
    got = _launched(ops.attention_kernel(dtype), lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window, kv_len=kv_len))
    assert got.shape == (B, Hq, S, Dv) and torch.isfinite(got).all()
    exp = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                  window=window, kv_len=kv_len)
    if dtype == torch.float32:
        torch.testing.assert_close(got, exp, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), exp.to(dtype).float(), rtol=2**-7, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["granite-3-2b", "h2o-danube-1.8b", "deepseek-7b",
                                  "granite-moe-1b-a400m", "deepseek-v2-lite-16b"])
def test_lm_smoke_on_card_matches_cpu(cuda, arch, dtype):
    """An LM's smoke config on the card (K4, n_layers launches a forward and
    a decode step; MLA's decode step none) against the same weights and
    tokens on the CPU (K4's plain version): float32 within 1e-4, bfloat16
    within 5e-2 (the two devices' matrix products round differently)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_arch(arch).smoke_config(), dtype=dtype)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = {"embed": params["embed"].to(cuda), "final_ln": params["final_ln"].to(cuda),
               "layers": {k: v.to(cuda) for k, v in params["layers"].items()}}
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 48),
                                                              dtype=np.int32))
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    kernel = ops.attention_kernel(dtype)
    ops.reset_launches()
    got = tf.forward(cfg, on_card, toks.to(cuda))[0]
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), tf.forward(cfg, params, toks)[0], rtol=0, atol=tol)
    cache, cpu_cache = tf.init_cache(cfg, 2, 48, cuda), tf.init_cache(cfg, 2, 48, "cpu")
    for t in range(48):
        ops.reset_launches()
        got = tf.decode_step(cfg, on_card, cache, toks[:, t:t + 1].to(cuda))[0]
        torch.cuda.synchronize()
        assert ops.LAUNCHES[kernel] == (0 if cfg.mla is not None else cfg.n_layers)
        exp = tf.decode_step(cfg, params, cpu_cache, toks[:, t:t + 1])[0]
        torch.testing.assert_close(got.cpu(), exp, rtol=0, atol=tol)


@pytest.mark.parametrize("arch", ["gcn-cora", "gatedgcn", "schnet", "graphcast"])
def test_gnn_smoke_on_card_matches_cpu(cuda, arch):
    """A GNN's smoke config on the card (GCN: K5, n_layers launches a
    forward) against the same weights and graph on the CPU, within 1e-4 (the
    card's index_add_ sums in the order its atomics land)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synth import graph_batch_from_csr
    from repro_torch.graph.generators import random_dag
    from repro_torch.models.gnn import gatedgcn, gcn, graphcast, schnet

    mod = {"gcn-cora": gcn, "gatedgcn": gatedgcn, "schnet": schnet, "graphcast": graphcast}[arch]
    cfg = get_arch(arch).smoke_config()
    params = mod.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = _to(params, cuda)
    if arch == "graphcast":
        rng = np.random.default_rng(0)
        n_g, extra = 48, (16,)
        ids = {"g2m_src": n_g, "g2m_dst": 16, "mesh_src": 16, "mesh_dst": 16, "m2g_src": 16,
               "m2g_dst": n_g}
        arrays = {"grid_x": rng.standard_normal((n_g, cfg.n_vars)).astype(np.float32),
                  **{k: rng.integers(0, hi, 96).astype(np.int32) for k, hi in ids.items()},
                  "target": rng.standard_normal((n_g, cfg.n_vars)).astype(np.float32)}
        batch = graphcast.MeshBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    else:
        g, extra = random_dag(64, 200, seed=0), ()
        batch = graph_batch_from_csr(
            g, 1 if arch == "schnet" else cfg.d_in, with_pos=arch == "schnet",
            d_edge=cfg.d_edge_in if arch == "gatedgcn" else None, pad_edges_to=g.m + 37,
            device="cpu")
    card_batch = type(batch)(*(None if a is None else a.to(cuda) for a in batch))
    ops.reset_launches()
    got = mod.forward(cfg, on_card, card_batch, *extra)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ell_spmm"] == (cfg.n_layers if arch == "gcn-cora" else 0)
    torch.testing.assert_close(got.cpu(), mod.forward(cfg, params, batch, *extra),
                               rtol=1e-4, atol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_xdeepfm_smoke_on_card_matches_cpu(cuda):
    """xDeepFM's smoke config on the card (K6, two launches a forward)
    against the same weights and ids on the CPU, within 1e-5."""
    from repro_torch.configs import xdeepfm_cfg
    from repro_torch.models.recsys import xdeepfm

    cfg = xdeepfm_cfg.smoke_config()
    params = xdeepfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = {k: ([w.to(cuda) for w in v] if k == "cin" else
                   [{n: t.to(cuda) for n, t in l.items()} for l in v] if k == "mlp" else
                   v.to(cuda)) for k, v in params.items()}
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_per_field, (300, cfg.n_fields), dtype=np.int32))
    ops.reset_launches()
    got = xdeepfm.forward(cfg, on_card, ids.to(cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["embedding_bag"] == 2
    torch.testing.assert_close(got.cpu(), xdeepfm.forward(cfg, params, ids), rtol=0, atol=1e-5)
    got = xdeepfm.retrieval_score(cfg, on_card, ids[:1].to(cuda), ids[:, 0].to(cuda), chunk=100)
    exp = xdeepfm.retrieval_score(cfg, params, ids[:1], ids[:, 0], chunk=100)
    torch.testing.assert_close(got.cpu(), exp, rtol=0, atol=1e-5)


def test_flash_attention_kernel_refuses_misaligned_kv(cuda, rng):
    """k or v one element into its storage: a ValueError before the launch
    (the kernel's 16-byte loads would fault), and the card still works."""
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 32)).astype(np.float32))
               .to(cuda).to(torch.bfloat16) for _ in range(3))
    buf = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)
    shifted = buf[1:].view(k.shape)
    shifted.copy_(k)
    ops.reset_launches()
    for args in ((q, shifted, v), (q, k, shifted)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.flash_attention(*args)
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["flash_attention_sm90"] == 0
    got = _launched("flash_attention_sm90", lambda: ops.flash_attention(q, k, v))
    exp = ref.flash_attention_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), exp.to(q.dtype).float(), rtol=2**-7, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_refuses_misaligned_q(cuda, rng, dtype):
    """q one element into its storage: a ValueError before either kernel
    launches (the sm90 kernel reads q 16 bytes at a time)."""
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 70, 24)).astype(np.float32))
               .to(cuda).to(dtype) for _ in range(3))
    buf = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    ops.reset_launches()
    with pytest.raises(ValueError, match="q must start at a 16-byte aligned"):
        ops.flash_attention(shifted, k, v)
    assert not any(ops.LAUNCHES.values())
    got = _launched(ops.attention_kernel(dtype), lambda: ops.flash_attention(q, k, v))
    exp = ref.flash_attention_ref(q.float(), k.float(), v.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, exp, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), exp.to(dtype).float(), rtol=2**-7, atol=1e-4)


def test_flash_attention_dispatches_by_dtype(cuda, rng):
    """A bfloat16 call launches the tensor-core kernel and never the CUDA-core
    one; a float32 call the other way round."""
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, 40, 64)).astype(np.float32))
               .to(cuda) for _ in range(3))
    for dtype, name, other in ((torch.bfloat16, "flash_attention_sm90", "flash_attention"),
                               (torch.float32, "flash_attention", "flash_attention_sm90")):
        ops.reset_launches()
        got = ops.flash_attention(*(t.to(dtype) for t in (q, k, v)))
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert ops.LAUNCHES[name] == 1 and ops.LAUNCHES[other] == 0, dict(ops.LAUNCHES)


@pytest.mark.parametrize("n,d,ns,F", [(32, 4, 50, 8), (96, 7, 200, 32), (64, 1, 64, 128),
                                      (4096, 16, 4096, 64), (1000, 40, 3000, 100),
                                      (7, 3, 9, 6), (1, 32, 5, 1)])
def test_ell_spmm_kernel_matches_plain(cuda, rng, n, d, ns, F):
    nbr = rng.integers(0, ns, size=(n, d)).astype(np.int32)
    nbr[rng.random((n, d)) < 0.3] = -1
    nbr[: max(n // 8, 1) // 2] = -1
    nbr[-1, 0] = ns - 1
    nbr, wgt = torch.from_numpy(nbr).to(cuda), torch.randn(n, d, device=cuda)
    x = torch.randn(ns, F, device=cuda)
    got = _launched("ell_spmm", lambda: ops.ell_spmm(nbr, wgt, x))
    torch.testing.assert_close(got, ref.ell_spmm_ref(nbr, wgt, x), rtol=1e-5, atol=1e-5)
    # rows not 16-byte aligned: the 4-byte path
    buf = torch.empty(ns * F + 1, device=cuda)
    x1 = buf[1:].view(ns, F)
    x1.copy_(x)
    got = _launched("ell_spmm", lambda: ops.ell_spmm(nbr, wgt, x1))
    torch.testing.assert_close(got, ref.ell_spmm_ref(nbr, wgt, x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", SPMM_CASES, ids=case_id)
def test_ell_spmm_kernel_edges(cuda, rng, case):
    n, d, ns, F, edge = case
    nbr, wgt, x = (torch.from_numpy(v).to(cuda) for v in make_spmm_case(rng, *case))
    if edge == "unaligned":   # rows off 16-byte lines: the 4-byte loads
        x = torch.empty(ns * F + 1, device=cuda)[1:].view(ns, F).copy_(x)
    got = _launched("ell_spmm", lambda: ops.ell_spmm(nbr, wgt, x))
    torch.testing.assert_close(got, ref.ell_spmm_ref(nbr, wgt, x), rtol=1e-5, atol=1e-5)
    assert not got[padding_rows(n, edge)].any()


def test_ell_spmm_kernel_refuses_bad_ids(cuda):
    x = torch.randn(6, 8, device=cuda)
    w = torch.ones(1, 2, device=cuda)
    for bad in (6, -2):
        nbr = torch.tensor([[0, bad]], dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="outside"):
            ops.ell_spmm(nbr, w, x)
    # past the first 32 slots of a row, beside good rows, at F = 100
    nbr = torch.zeros(3, 40, dtype=torch.int32, device=cuda)
    nbr[1, 37] = 6
    with pytest.raises(ValueError, match="outside"):
        ops.ell_spmm(nbr, torch.ones(3, 40, device=cuda), torch.randn(6, 100, device=cuda))


@pytest.mark.parametrize("V,D,B,bag", [(100, 8, 32, 4), (500, 16, 64, 9), (64, 32, 16, 1),
                                       (100_000, 16, 8192, 8), (1000, 10, 5000, 8),
                                       (50, 3, 1, 5)])
def test_embedding_bag_kernel_matches_plain(cuda, rng, V, D, B, bag):
    idx = rng.integers(0, V, size=(B, bag)).astype(np.int32)
    pad = rng.random((B, bag)) < 0.25
    idx[pad] = rng.integers(-2**31, 0, size=int(pad.sum()))   # any negative id pads
    idx[0] = -1
    idx[-1, -1] = V - 1
    idx, table = torch.from_numpy(idx).to(cuda), torch.randn(V, D, device=cuda)
    got = _launched("embedding_bag", lambda: ops.embedding_bag(table, idx))
    torch.testing.assert_close(got, ref.embedding_bag_ref(table, idx), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", BAG_CASES, ids=case_id)
def test_embedding_bag_kernel_edges(cuda, rng, case):
    V, D, B, bag, edge = case
    table, idx = (torch.from_numpy(v).to(cuda) for v in make_bag_case(rng, *case))
    if edge == "unaligned":   # rows off 8-byte lines: the 4-byte loads
        table = torch.empty(V * D + 1, device=cuda)[1:].view(V, D).copy_(table)
    got = _launched("embedding_bag", lambda: ops.embedding_bag(table, idx))
    torch.testing.assert_close(got, ref.embedding_bag_ref(table, idx), rtol=1e-5, atol=1e-5)
    assert not got[padding_rows(B, edge)].any()


def test_embedding_bag_kernel_refuses_bad_ids(cuda):
    table = torch.randn(6, 10, device=cuda)
    with pytest.raises(ValueError, match=">= V"):
        ops.embedding_bag(table, torch.tensor([[0, 6]], dtype=torch.int32, device=cuda))
    # in a later slot group of a 40-slot bag beside good bags, at D = 11 and 64
    for D, bag, slot in ((11, 40, 37), (64, 9, 8)):
        idx = torch.zeros(3, bag, dtype=torch.int32, device=cuda)
        idx[1, slot] = 6
        with pytest.raises(ValueError, match=">= V"):
            ops.embedding_bag(torch.randn(6, D, device=cuda), idx)
    # the flag is cleared by the next call: a good call after a bad one passes
    idx = torch.tensor([[0, 5, -1]], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(ops.embedding_bag(table, idx), table[0:1] + table[5:6])



# ------------------------------------------------------------------ backwards


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTENTION_BWD_CASES, ids=case_id)
def test_flash_attention_bwd_kernel_matches_plain(cuda, rng, case, dtype):
    """K4's backward (one ``flash_attention_bwd`` launch, through the kernel
    of its dtype: bfloat16 ``flash_attention_bwd_sm90``, float32 the CUDA
    cores') against its plain version on the same inputs and output, within
    ATTENTION_BWD_TOL; rows that see no key get no gradient."""
    B, Hq, Hkv, S, T, D, Dv, causal, window = case
    q, k, v, do = (torch.from_numpy(a).to(cuda, dtype)
                   for a in make_attention_bwd_case(rng, *case))
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    got = _launched(ops.attention_bwd_kernel(dtype), lambda: _launched(
        "flash_attention_bwd",
        lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)))
    exp = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    rtol, atol = ATTENTION_BWD_TOL[str(dtype).removeprefix("torch.")]
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        assert g.dtype == dtype and g.shape == e.shape, name
        e = e.float()
        torch.testing.assert_close(g.float(), e, rtol=rtol,
                                   atol=atol * max(float(e.abs().max()), 1e-30), msg=name)
    blind = torch.from_numpy(~attention_rows_seeing_a_key(S, T, causal, window)).to(cuda)
    assert not got[0][:, :, blind].any()


def test_flash_attention_bwd_through_autograd_on_the_card(cuda, rng):
    """``loss.backward()`` through ``ops.flash_attention`` launches the
    backward kernel once and no plain version; a call over a kv_len prefix
    has no backward."""
    from unittest import mock

    q, k, v, do = (torch.from_numpy(a).to(cuda).requires_grad_(True)
                   for a in make_attention_bwd_case(rng, 1, 4, 2, 100, 100, 64, 64, True, 20))
    with mock.patch.object(ref, "flash_attention_bwd_ref", side_effect=AssertionError), \
            mock.patch.object(ref, "flash_attention_ref", side_effect=AssertionError):
        ops.reset_launches()
        (ops.flash_attention(q, k, v, causal=True, window=20) * do.detach()).sum().backward()
        torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1 and ops.LAUNCHES["flash_attention_bwd"] == 1
    exp = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      ref.flash_attention_ref(q.detach(), k.detach(), v.detach(),
                                                              window=20), do.detach(), window=20)
    for g, e in zip((q.grad, k.grad, v.grad), exp):
        torch.testing.assert_close(g, e, rtol=0, atol=1e-4 * float(e.abs().max()))
    out = ops.flash_attention(q, k, v, kv_len=50)
    with pytest.raises(ValueError, match="kv_len"):
        out.sum().backward()


@pytest.mark.parametrize("case", ATTENTION_BWD_CASES, ids=case_id)
def test_flash_attention_lse_matches_plain(cuda, rng, case):
    """K4's bfloat16 forward keeps each row's base-2 log-sum-exp for the
    backward: within ATTENTION_LSE_TOL of the plain version's where a row
    sees a key, +inf where it sees none; its output equal, bit for bit, to
    the call that keeps none (serving's)."""
    B, Hq, Hkv, S, T, D, Dv, causal, window = case
    q, k, v, _ = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                  for a in make_attention_bwd_case(rng, *case))
    out, lse = _launched("flash_attention_sm90", lambda: ops._flash_attention(
        q, k, v, causal, window, D ** -0.5, T, return_lse=True))
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, S)
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=causal, window=window))
    _, exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    seen = torch.from_numpy(attention_rows_seeing_a_key(S, T, causal, window)).to(cuda)
    assert torch.isposinf(lse[:, :, ~seen]).all()
    torch.testing.assert_close(lse[:, :, seen], exp[:, :, seen], rtol=0, atol=ATTENTION_LSE_TOL)


# decode rows of the float32 short-row kernel with their lse: (B, Hq, Hkv, T,
# D, kv_len, window); danube's 32 q heads over 8 kv heads of 80, a window
# inside the prefix, a window of one key, the whole cache
F32_LSE_DECODE_CASES = [(1, 32, 8, 4096, 80, 4096, None), (1, 32, 8, 4096, 80, 1000, 300),
                        (1, 32, 8, 4096, 80, 4096, 1), (2, 4, 2, 100, 64, 37, None)]


@pytest.mark.parametrize("case", ATTENTION_BWD_CASES, ids=case_id)
def test_flash_attention_f32_lse_matches_plain(cuda, rng, case):
    """K4's float32 kernel writes each row's base-2 log-sum-exp when asked
    (``return_lse``, at inference): within ATTENTION_LSE_TOL of the plain
    version's where a row sees a key, +inf where it sees none; its output equal, bit for
    bit, to the call that keeps none."""
    B, Hq, Hkv, S, T, D, Dv, causal, window = case
    q, k, v, _ = (torch.from_numpy(a).to(cuda) for a in make_attention_bwd_case(rng, *case))
    out, lse = _launched("flash_attention", lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window, return_lse=True))
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, S)
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=causal, window=window))
    _, exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    seen = torch.from_numpy(attention_rows_seeing_a_key(S, T, causal, window)).to(cuda)
    assert torch.isposinf(lse[:, :, ~seen]).all()
    torch.testing.assert_close(lse[:, :, seen], exp[:, :, seen], rtol=0, atol=ATTENTION_LSE_TOL)


@pytest.mark.parametrize("case", F32_LSE_DECODE_CASES)
def test_flash_attention_f32_decode_lse_matches_plain(cuda, rng, case):
    """The float32 short-row kernel's lse at decode (one query row a q head
    over a filled prefix ``kv_len`` of a longer cache, a window), as a
    rank of a sequence-split decode asks for it: out (2e-5) and lse
    (ATTENTION_LSE_TOL) against the plain version."""
    B, Hq, Hkv, T, D, kv_len, window = case
    q = torch.from_numpy(rng.standard_normal((B, Hq, 1, D)).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, T, D)).astype(np.float32)).to(cuda)
            for _ in range(2))
    out, lse = _launched("flash_attention", lambda: ops.flash_attention(
        q, k, v, window=window, kv_len=kv_len, return_lse=True))
    exp_out, exp = ref.flash_attention_ref(q, k, v, window=window, kv_len=kv_len,
                                           return_lse=True)
    torch.testing.assert_close(out, exp_out, rtol=0, atol=2e-5)
    torch.testing.assert_close(lse, exp, rtol=0, atol=ATTENTION_LSE_TOL)


def test_flash_attention_bwd_bf16_keeps_lse_on_the_card(cuda, rng):
    """``loss.backward()`` through a bfloat16 ``ops.flash_attention`` launches
    the forward once (keeping lse) and the tensor-core backward once, no
    plain version; the gradients within ATTENTION_BWD_TOL of the plain
    backward's; a call under ``torch.no_grad`` keeps no lse."""
    from unittest import mock

    q, k, v, do = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                   for a in make_attention_bwd_case(rng, 2, 8, 2, 300, 300, 64, 64, True, None))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    with mock.patch.object(ref, "flash_attention_bwd_ref", side_effect=AssertionError), \
            mock.patch.object(ref, "flash_attention_ref", side_effect=AssertionError), \
            mock.patch.object(ops, "_flash_attention", wraps=ops._flash_attention) as fwd:
        ops.reset_launches()
        out = ops.flash_attention(q, k, v)
        (out * do).sum().backward()
        torch.cuda.synchronize()
        assert [c.kwargs.get("return_lse") for c in fwd.call_args_list] == [True]
        with torch.no_grad():
            ops.flash_attention(q, k, v)
        assert fwd.call_args_list[-1].kwargs.get("return_lse") in (None, False)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
        "flash_attention_sm90": 2, "flash_attention_bwd": 1, "flash_attention_bwd_sm90": 1}
    exp = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(), do)
    rtol, atol = ATTENTION_BWD_TOL["bfloat16"]
    for g, e in zip((q.grad, k.grad, v.grad), exp):
        e = e.float()
        torch.testing.assert_close(g.float(), e, rtol=rtol, atol=atol * float(e.abs().max()))


@pytest.mark.parametrize("case", ATTENTION_BWD_CASES, ids=case_id)
def test_flash_attention_f32_bwd_reads_the_forwards_lse(cuda, rng, case):
    """K4's float32 backward given the forward's lse: exactly one
    ``flash_attention_bwd`` launch and no forward launch, within
    ATTENTION_BWD_TOL of the plain version; the control, a dq without the
    last key tile's parts (the plain parts of keys T - 64 .. T - 1, which keep
    their right-aligned positions), must be rejected where those parts are
    not zero."""
    B, Hq, Hkv, S, T, D, Dv, causal, window = case
    q, k, v, do = (torch.from_numpy(a).to(cuda) for a in make_attention_bwd_case(rng, *case))
    o, lse = ops.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    torch.cuda.synchronize()
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {"flash_attention_bwd": 1}
    exp = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    rtol, atol = ATTENTION_BWD_TOL["float32"]
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        assert g.dtype == torch.float32 and g.shape == e.shape, name
        torch.testing.assert_close(g, e, rtol=rtol, atol=atol * max(float(e.abs().max()), 1e-30),
                                   msg=name)
    last = ref.flash_attention_bwd_ref(q, k[:, :, -64:].contiguous(), v[:, :, -64:].contiguous(),
                                       o, do, causal=causal, window=window, lse=lse)[0]
    if bool(last.abs().max() > 0):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(got[0] - last, exp[0], rtol=rtol,
                                       atol=atol * float(exp[0].abs().max()))


def test_flash_attention_bwd_f32_keeps_lse_on_the_card(cuda, rng):
    """``loss.backward()`` through a float32 ``ops.flash_attention`` launches
    the forward once (keeping lse) and the backward once, no plain version;
    the gradients within ATTENTION_BWD_TOL of the plain backward's; a call
    under ``torch.no_grad`` keeps no lse."""
    from unittest import mock

    q, k, v, do = (torch.from_numpy(a).to(cuda)
                   for a in make_attention_bwd_case(rng, 2, 8, 2, 300, 300, 64, 64, True, None))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    with mock.patch.object(ref, "flash_attention_bwd_ref", side_effect=AssertionError), \
            mock.patch.object(ref, "flash_attention_ref", side_effect=AssertionError), \
            mock.patch.object(ops, "_flash_attention", wraps=ops._flash_attention) as fwd:
        ops.reset_launches()
        out = ops.flash_attention(q, k, v)
        (out * do).sum().backward()
        torch.cuda.synchronize()
        assert [c.kwargs.get("return_lse") for c in fwd.call_args_list] == [True]
        with torch.no_grad():
            ops.flash_attention(q, k, v)
        assert fwd.call_args_list[-1].kwargs.get("return_lse") in (None, False)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
        "flash_attention": 2, "flash_attention_bwd": 1}
    exp = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(), do)
    rtol, atol = ATTENTION_BWD_TOL["float32"]
    for g, e in zip((q.grad, k.grad, v.grad), exp):
        torch.testing.assert_close(g, e, rtol=rtol, atol=atol * float(e.abs().max()))


@pytest.mark.parametrize("F", [1, 7, 16, 64])
def test_ell_spmm_narrow_rows_refuse_bad_ids(cuda, rng, F):
    """K5's narrow-row kernel (F <= 64) through the flag word: a bad id past
    the first 32 slots of a row, beside good rows, raises ``ValueError``; the
    next good call passes (the wrapper clears the flag) and matches the plain
    version."""
    n, d, ns = 70, 40, 50
    x = torch.randn(ns, F, device=cuda)
    nbr = torch.from_numpy(rng.integers(-1, ns, size=(n, d)).astype(np.int32)).to(cuda)
    wgt = torch.randn(n, d, device=cuda)
    bad = nbr.clone()
    bad[33, 37] = ns
    with pytest.raises(ValueError, match="outside"):
        ops.ell_spmm(bad, wgt, x)
    got = _launched("ell_spmm", lambda: ops.ell_spmm(nbr, wgt, x))
    torch.testing.assert_close(got, ref.ell_spmm_ref(nbr, wgt, x), rtol=SPMM_BAG_BWD_TOL,
                               atol=SPMM_BAG_BWD_TOL)


@pytest.mark.parametrize("case", BAG_BWD_CASES, ids=case_id)
def test_embedding_bag_bwd_kernel_matches_plain(cuda, rng, case):
    """K6's backward (one ``embedding_bag_bwd`` launch: a zeroed table and
    float32 atomics) against ``index_add_``, repeated ids within and across
    bags among the cases; and through autograd."""
    V, D, B, bag, edge = case
    idx, dout = (torch.from_numpy(a).to(cuda) for a in make_bag_bwd_case(rng, *case))
    got = _launched("embedding_bag_bwd", lambda: ops.embedding_bag_bwd(idx, dout, V))
    exp = ref.embedding_bag_bwd_ref(idx, dout, V)
    torch.testing.assert_close(got, exp, rtol=SPMM_BAG_BWD_TOL, atol=SPMM_BAG_BWD_TOL)
    table = torch.randn(V, D, device=cuda, requires_grad=True)
    ops.reset_launches()
    (ops.embedding_bag(table, idx) * dout).sum().backward()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["embedding_bag"] == 1 and ops.LAUNCHES["embedding_bag_bwd"] == 1
    torch.testing.assert_close(table.grad, exp, rtol=SPMM_BAG_BWD_TOL, atol=SPMM_BAG_BWD_TOL)


@pytest.mark.parametrize("case", SPMM_BWD_CASES, ids=case_id)
def test_ell_spmm_bwd_is_k5_over_the_transposed_rows(cuda, rng, case):
    """K5's backward through autograd: one ``ell_spmm`` launch over the
    transposed rows (counted as ``ell_spmm_bwd``), against the plain
    version's autograd gradient; a wgt that requires grad raises."""
    nbr, wgt, nbr_t, wgt_t, x, dout = (torch.from_numpy(a).to(cuda)
                                       for a in make_spmm_bwd_case(rng, *case))
    x.requires_grad_(True)
    ops.reset_launches()
    (ops.ell_spmm(nbr, wgt, x, nbr_t, wgt_t) * dout).sum().backward()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ell_spmm"] == 1 and ops.LAUNCHES["ell_spmm_bwd"] == 1
    xp = x.detach().clone().requires_grad_(True)
    (ref.ell_spmm_ref(nbr, wgt, xp) * dout).sum().backward()
    torch.testing.assert_close(x.grad, xp.grad, rtol=SPMM_BAG_BWD_TOL, atol=SPMM_BAG_BWD_TOL)
    with pytest.raises(ValueError, match="wgt"):
        ops.ell_spmm(nbr, wgt.clone().requires_grad_(True), x, nbr_t, wgt_t)


@pytest.mark.parametrize("arch", ["granite-3-2b", "xdeepfm", "gcn-cora"])
def test_train_steps_on_card_match_cpu(cuda, arch):
    """Three training steps (``launch.train``'s setup and step) at the smoke
    config, float32, from the same weights on the card (K4, K5, K6 and their
    backward kernels) and on the CPU: the losses within 1e-4, the gradient
    norms within 1e-3, and the backward kernel launched every step."""
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    argv = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "4", "--seq", "64",
            "--gnn-nodes", "200"]
    bwd = {"granite-3-2b": "flash_attention_bwd", "xdeepfm": "embedding_bag_bwd",
           "gcn-cora": "ell_spmm_bwd"}[arch]
    logs, start = {}, None
    for dev in ("cpu", "cuda"):
        args = train.parse_args(argv + ["--device", dev])
        _, params, loss_of, batch_fn, wd = train.setup(args)
        if start is None:   # the CPU's weights, kept before its steps update them in place
            start = tree_map(lambda p: p.detach().clone(), params)
        else:
            params = tree_map(lambda p: p.to(cuda), start)
        state, step = (params, adamw_init(params)), train.make_step(loss_of, args, wd)
        logs[dev] = []
        for s in range(3):
            ops.reset_launches()
            state, metrics = step(state, batch_fn(s))
            logs[dev].append({k: float(v) for k, v in metrics.items()})
            if dev == "cuda":
                assert ops.LAUNCHES[bwd] >= 1, ops.LAUNCHES
    for g, e in zip(logs["cuda"], logs["cpu"]):
        np.testing.assert_allclose(g["loss"], e["loss"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], e["grad_norm"], rtol=1e-3, atol=1e-4)


# ------------------------------------------------------------------ training across ranks

CARD_RANKS_SNIPPET = r"""
import datetime, sys, numpy as np, torch, torch.distributed as dist
from repro_torch.configs import granite_3_2b, gatedgcn_cfg
from repro_torch.configs.lm_cells import make_train_step, opt_layout
from repro_torch.dist import pipeline_apply
from repro_torch.graph.generators import random_dag
from repro_torch.graph.partition import partition_edges_by_dst
from repro_torch.launch.mesh import form_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import gatedgcn
from repro_torch.models.gnn.layers import GraphBatch
from repro_torch.optim import quantized_psum_grads, zero_init
from repro_torch.tree import tree_leaves
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dev = torch.device('cuda', 0)
dist.init_process_group('gloo', store=dist.FileStore(store, world), rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
# every collective this slice takes, on CUDA tensors under gloo
g = dist.new_group(list(range(world)))
for dt in (torch.int8, torch.uint8, torch.bfloat16, torch.float32):
    out = torch.empty(3 * world, dtype=dt, device=dev)
    dist.all_gather_into_tensor(out, torch.full((3,), rank + 1, dtype=dt, device=dev), group=g)
    assert out.view(world, 3).float().tolist() == [[r + 1.0] * 3 for r in range(world)], dt
for dt in (torch.float32, torch.int64):
    t = torch.full((2,), rank + 1, dtype=dt, device=dev)
    dist.all_reduce(t, group=g)
    assert t.tolist() == [world * (world + 1) // 2] * 2, dt
out = torch.empty(2, dtype=torch.float32, device=dev)
dist.reduce_scatter_tensor(out, torch.arange(2 * world, dtype=torch.float32, device=dev), group=g)
assert out.tolist() == [world * (2 * rank), world * (2 * rank + 1)]
for dt in (torch.bfloat16, torch.float32):
    t = torch.full((4,), float(rank), dtype=dt, device=dev)
    dist.broadcast(t, src=world - 1, group=g)
    assert t.tolist() == [world - 1.0] * 4, dt
# make_train_step over the ranks against one rank, on the card
cfg = granite_3_2b.smoke_config()
gen = torch.Generator(device=dev).manual_seed(0)
p0 = tf.init_params(cfg, gen, dev)
tok = torch.randint(0, cfg.vocab, (8, 64), generator=gen, device=dev)
lab = torch.randint(0, cfg.vocab, (8, 64), generator=gen, device=dev)
lab[0, :50] = -1
batch = {'tokens': tok, 'labels': lab}
res = {}
for m in (form_mesh((world, 1), ('data', 'model'), device_type='cuda'), None):
    p = {k: (v.clone() if not isinstance(v, dict) else {a: b.clone() for a, b in v.items()})
         for k, v in p0.items()}
    st = zero_init(p, opt_layout(cfg, p, m))
    step = make_train_step(cfg, 2, m)
    for _ in range(2):
        p, st, met = step(p, st, batch)
    res[m is None] = (float(met['loss']), [x.detach().cpu() for x in tree_leaves(p)])
assert abs(res[True][0] - res[False][0]) <= 1e-5 * abs(res[True][0]), res
for a, b in zip(res[True][1], res[False][1]):
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
# quantized_psum_grads against its formula on the host
dm = form_mesh((world,), ('data',), device_type='cuda')
x = torch.randn(1000, generator=gen, device=dev) * (rank + 1)
got = quantized_psum_grads({'x': x}, dm)['x'].cpu().numpy()
parts = [torch.empty_like(x) for _ in range(world)]
dist.all_gather(parts, x)
qs, ss = [], []
for a in parts:
    flat = np.pad(a.cpu().numpy(), (0, 24)).reshape(-1, 256)
    s = np.abs(flat).max(1, keepdims=True) / np.float32(127.0)
    qs.append(np.clip(np.round(flat / s), -127, 127).astype(np.int32))
    ss.append(s.astype(np.float32))
want = (sum(qs).astype(np.float32) * (sum(ss) / np.float32(world))).reshape(-1)[:1000] / world
assert np.array_equal(got, want), np.abs(got - want).max()
# pipeline_apply against the sequential run
sm = form_mesh((world,), ('stage',), device_type='cuda')
w = torch.randn((world, 2, 16, 16), generator=gen, device=dev) * 0.3
xs = torch.randn((8, 4, 16), generator=gen, device=dev)
def stage(p, h):
    for i in range(2):
        h = torch.tanh(h @ p['w'][i])
    return h
mine = w[rank:rank + 1].clone().requires_grad_(True)
out = pipeline_apply({'w': mine}, xs, stage, sm)
(gw,) = torch.autograd.grad(out.sum(), [mine])
ref = xs
wr = w.clone().requires_grad_(True)
for s in range(world):
    ref = stage({'w': wr[s]}, ref)
(rw,) = torch.autograd.grad(ref.sum(), [wr])
assert torch.allclose(out, ref, atol=1e-5) and torch.allclose(gw[0], rw[rank], atol=1e-5)
# gatedgcn's dst-local loss against loss_fn
gc = gatedgcn_cfg.smoke_config()
gg = random_dag(64, 200, seed=1)
src, dst, mask, _ = partition_edges_by_dst(gg, world, n_pad=64)
rng = np.random.default_rng(0)
t = lambda a: torch.from_numpy(a).to(dev)
b = GraphBatch(x=t(rng.standard_normal((64, gc.d_in)).astype(np.float32)), edge_src=t(src),
               edge_dst=t(dst), edge_mask=t(mask), node_mask=torch.ones(64, dtype=torch.bool, device=dev),
               edge_attr=t(rng.standard_normal((src.shape[0], gc.d_edge_in)).astype(np.float32)),
               y=t(rng.integers(0, gc.n_classes, 64).astype(np.int32)))
params = gatedgcn.init_params(gc, gen, dev)
leaves = [q.requires_grad_(True) for q in tree_leaves(params)]
base = gatedgcn.loss_fn(gc, params, b)
bg = torch.autograd.grad(base, leaves, allow_unused=True, materialize_grads=True)
loss = gatedgcn.make_dstlocal_loss(gc, dm)(params, b)
assert abs(float(loss) - float(base)) < 5e-3
# the exchange in float32 (the same Function without the bfloat16 rounding):
# loss and gradients those of loss_fn on one rank
from unittest import mock
from repro_torch.launch.mesh import gather_rows, scatter_sum_rows
class Gather32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, ag):
        ctx.ag = ag
        return gather_rows(h, ag)
    @staticmethod
    def backward(ctx, grad):
        return scatter_sum_rows(grad, ctx.ag), None
with mock.patch.object(gatedgcn, '_gather_nodes', Gather32.apply):
    loss = gatedgcn.make_dstlocal_loss(gc, dm)(params, b)
    lg = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
assert abs(float(loss) - float(base)) < 1e-5
for a, c in zip(lg, bg):
    assert float((a - c).abs().max()) <= 1e-5 * max(float(c.abs().max()), 1e-30) + 1e-7
dist.destroy_process_group()
print('CARD_RANKS_OK')
"""


def test_training_across_gloo_ranks_on_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card (NCCL puts no two ranks on one
    device): every collective this slice takes on CUDA tensors
    (``all_gather_into_tensor`` of int8, uint8, bfloat16 and float32,
    ``all_reduce`` SUM of float32 and int64, ``reduce_scatter_tensor``,
    ``broadcast``), then ``make_train_step`` over the ranks against one
    rank (1e-5), ``quantized_psum_grads`` against its formula bit for bit,
    ``pipeline_apply`` against the sequential run and
    ``make_dstlocal_loss`` against ``loss_fn`` (the loss at JAX's bound;
    with the node stream exchanged in float32, loss and gradients at
    1e-5)."""
    import os
    import pathlib
    import subprocess
    import sys

    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    procs = [subprocess.Popen([sys.executable, "-c", CARD_RANKS_SNIPPET, str(r), "2",
                               str(tmp_path / "store")], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0 and "CARD_RANKS_OK" in log, log[-3000:]


CARD_TP_SNIPPET = r"""
import datetime, sys, torch, torch.distributed as dist
from repro_torch.configs import granite_3_2b
from repro_torch.configs.lm_cells import make_train_step, opt_layout
from repro_torch.dist.tensor_parallel import model_group
from repro_torch.kernels import ops
from repro_torch.launch.mesh import form_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim import zero_init
from repro_torch.tree import tree_leaves
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dev = torch.device('cuda', 0)
dist.init_process_group('gloo', store=dist.FileStore(store, world), rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
mesh = form_mesh((1, world), ('data', 'model'), device_type='cuda')
mg = model_group(mesh)
# granite's smoke config, 2 kv heads over the model ranks, float32
cfg = granite_3_2b.smoke_config()
def fresh():
    return tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
gen = torch.Generator(device=dev).manual_seed(1)
tok = torch.randint(0, cfg.vocab, (4, 64), generator=gen, device=dev)
lab = torch.randint(0, cfg.vocab, (4, 64), generator=gen, device=dev)
batch = {'tokens': tok, 'labels': lab}
ref = fresh()
ref, _, ref_m = make_train_step(cfg, 2, None)(ref, zero_init(ref, opt_layout(cfg, ref, None)),
                                               batch)
p = tf.shard_params(cfg, fresh(), mesh)
st = zero_init(p, opt_layout(cfg, p, mesh))
ops.reset_launches()
p, st, met = make_train_step(cfg, 2, mesh)(p, st, batch)
torch.cuda.synchronize()
assert ops.LAUNCHES['flash_attention'] == 2 * cfg.n_layers, ops.LAUNCHES
assert ops.LAUNCHES['flash_attention_bwd'] == 2 * cfg.n_layers, ops.LAUNCHES
assert abs(float(met['loss']) - float(ref_m['loss'])) <= 1e-5 * abs(float(ref_m['loss']))
for a, b in zip(tree_leaves(tf.gather_params(cfg, p, mesh)), tree_leaves(ref)):
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-6), float((a - b).abs().max())
# prefill, each rank K4 over its own heads
toks = torch.randint(0, cfg.vocab, (2, 96), generator=gen, device=dev)
whole = fresh()
got = tf.prefill(cfg, tf.shard_params(cfg, whole, mesh), toks, mg)
assert (got - tf.prefill(cfg, whole, toks)).abs().max() <= 1e-4
dist.destroy_process_group()
print('CARD_TP_OK')
"""


def test_tensor_parallel_on_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card over a (1, 2) ("data", "model") mesh:
    granite's smoke config in float32 (2 kv heads, one a rank) through
    ``make_train_step`` with each rank's ``param_pspecs`` blocks, the params
    gathered whole against the one-rank step (1e-5), K4 and its backward
    launched on every rank over its own heads; ``prefill`` over the ranks
    against one rank (1e-4)."""
    import os
    import pathlib
    import subprocess
    import sys

    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    procs = [subprocess.Popen([sys.executable, "-c", CARD_TP_SNIPPET, str(r), "2",
                               str(tmp_path / "store")], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0 and "CARD_TP_OK" in log, log[-3000:]


@pytest.mark.parametrize("row_extract", ["gather", "onehot"])
def test_production_cell_programs_on_the_card(cuda, rng, row_extract):
    """The production cells' programs on one rank (``mesh`` None) on the
    card: ``make_sharded_distribute_one`` over a random DAG's first 20
    vertices of the §5.2 order gives the CPU run's state exactly after each
    (no kernel launched), and ``make_row_sharded_serve_step`` answers with
    one K1 tier-form launch at the full width, equal to its plain version."""
    from repro_torch.core.distribution_device import init_state, make_sharded_distribute_one
    from repro_torch.core.order import get_order
    from repro_torch.graph.generators import random_dag
    from repro_torch.serve.engine import make_row_sharded_serve_step

    g = random_dag(400, 1200, seed=5)
    fs, fd = (torch.from_numpy(np.asarray(x, np.int32)) for x in g.edges())
    step = make_sharded_distribute_one(None, g.n, 64, row_extract)
    host, card = init_state(g.n, 16, device="cpu"), init_state(g.n, 16, device=cuda)
    ops.reset_launches()
    for vi in get_order(g, "degree_product")[:20]:
        v = torch.tensor(int(vi), dtype=torch.int32)
        host = step(host, v, fs, fd, fd, fs)
        card = step(card, v.to(cuda), fs.to(cuda), fd.to(cuda), fd.to(cuda), fs.to(cuda))
        for a, b in zip(host, card):
            assert torch.equal(a, b.cpu())
    assert not any(ops.LAUNCHES.values())
    q = torch.from_numpy(rng.integers(0, g.n, (5000, 2)).astype(np.int32)).to(cuda)
    got = make_row_sharded_serve_step(None)(card.L_out, card.L_in, q)
    assert ops.LAUNCHES["label_intersect"] == 1
    assert torch.equal(got, ref.tier_intersect_ref(card.L_out, card.L_in, q, 16))
