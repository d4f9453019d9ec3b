"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: rank 0 of
each cell traced on ``meta`` tensors over a fake process group, allocating
nothing; the kernel wrappers' ``meta`` path; the roofline report and the
trace profiler.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS, get_arch
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, roofline, trace_top

M = "meta"


def _run(arch, shape, mesh_kind="single", variant="baseline", mesh_shape=None):
    return dryrun.run_cell(arch, shape, mesh_kind, variant, None, mesh_shape=mesh_shape)


@pytest.mark.parametrize("shape,want", [
    # 2 x 625,000 x 64 x 4 label bytes + 62,500 x 8 query bytes
    ("serve_1m", 320_500_000),
    # the label rows, the two lengths, 4 x 1,875,000 int32 edges, overflow and vi
    ("build_sweep", 320_000_000 + 5_000_000 + 30_000_000 + 5),
])
def test_oracle_argument_bytes_are_exact(shape, want):
    rec = _run("reachability-oracle", shape)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["n_chips"] == 256 and rec["roofline"]["source"] == "trace"
    assert rec["cost"]["bytes_accessed"] > want / 2


def test_serve_cell_counts_its_exchange_and_kernel():
    """serve_1m on ``single``: three all-to-alls a matrix (counts, ids,
    rows) and the verdicts' all-gather; one K1 tier-form call at width 64
    over rank 0's 62,500 queries."""
    rec = _run("reachability-oracle", "serve_1m")
    k1 = rec["kernels"]["label_intersect"]
    assert k1["calls"] == 1 and k1["flops"] == 62_500 * 64 * 64
    assert rec["collectives"]["count"] == 7
    assert rec["collectives"]["all-gather"] == 1_000_000   # the bool verdicts
    # the rows coming back: 62,500 x 64 x 4 bytes a matrix
    assert rec["collectives"]["all-to-all"] >= 2 * 62_500 * 64 * 4


def test_build_cell_gather_and_onehot_rows():
    """build_sweep: the baseline gathers vi's row by an all-gather of each
    label matrix (JAX's measured 2 x 2.56 GB), ``rowfix`` by an [L]
    all-reduce: its all-gather bytes are the frontier words alone."""
    base = _run("reachability-oracle", "build_sweep")
    fix = _run("reachability-oracle", "build_sweep", variant="rowfix")
    assert base["status"] == fix["status"] == "ok"
    assert base["collectives"]["all-gather"] - fix["collectives"]["all-gather"] == \
        2 * 10_000_000 * 64 * 4
    # 64 steps a pass, two passes: one frontier all-gather and one
    # reduce-scatter a step
    assert fix["collectives"]["reduce-scatter"] == 2 * 64 * 10_000_000


def test_small_mesh_dryrun_cell():
    """The counterpart of tests/test_dist.py's: gcn-cora full_graph_sm on a
    (4, 2) fake mesh traces ``ok``; its matmul FLOPs are GCN's dense
    products on rank 0's 768 rows: the forward's two, the backward's three
    (x takes no gradient)."""
    rec = _run("gcn-cora", "full_graph_sm", mesh_shape=((4, 2), ("data", "model")))
    assert rec["status"] == "ok", rec.get("traceback")
    n_local, d_in, h, c = 3072 // 4, 1433, 16, 7
    assert rec["cost"]["matmul_flops"] == 2 * n_local * (2 * d_in * h + 3 * h * c)


def test_equal_meshes_keep_their_own_groups():
    """Two meshes of one shape compare equal: the groups ``form_mesh`` made
    for the second outlive the first (a dry run forms a mesh a cell, and
    the last cell's may be collected while the next runs)."""
    import gc

    import torch.distributed as dist

    from repro_torch.launch.mesh import axis_group, form_mesh

    try:
        first = dryrun.fake_mesh((2, 2), ("data", "model"))
        second = form_mesh((2, 2), ("data", "model"), device_type="cpu")
        assert first == second
        del first
        gc.collect()
        assert axis_group(second, ("model",)).size == 2
        assert axis_group(second, ("data",)).size == 2
    finally:
        dist.destroy_process_group()


def test_tensor_parallel_cell_counts_its_backward_collectives():
    """A tensor-parallel LM train cell (granite's smoke config, 3 layers, at
    train_4k's shapes in one microbatch) on a (1, 4) fake mesh: the
    collectives of the forward and those of the autograd Functions'
    backwards are counted.  With 2 kv heads over 4 model ranks each layer
    gathers k and v (all-gathers; their adjoints reduce-scatters); the
    all-reduces: the embedding, each layer's two row-split outputs, the
    cross-entropy's max, sum and target, the backward's ``copy_to_model``
    of each layer's two inputs and of the logits' input, and the clip's
    norm over the model ranks."""
    import torch.distributed as dist

    from repro_torch.configs import granite_3_2b, lm_cells

    cfg = granite_3_2b.smoke_config()
    try:
        mesh = dryrun.fake_mesh((1, 4), ("data", "model"))
        cell = lm_cells.lm_cell(cfg, "granite-3-2b", "train_4k", mesh, accum_micro_per_device=256)
        rec = dryrun.trace_cell(cell, mesh)
    finally:
        dist.destroy_process_group()
    L = cfg.n_layers
    assert cell.meta["n_accum"] == 1
    assert rec["comm_counts"] == {"c10d.allreduce_": 4 * L + 6, "c10d._allgather_base_": 2 * L,
                                  "c10d._reduce_scatter_base_": 2 * L}
    # k and v: [256, 4096, 2 kv heads x 16] float32 gathered, each layer
    assert rec["collectives"]["all-gather"] == rec["collectives"]["reduce-scatter"] == \
        2 * L * 256 * 4096 * 32 * 4


@pytest.mark.parametrize("mesh_kind,variant", [("single", "baseline"), ("multi", "baseline"),
                                               ("single", "tp1")])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_cell_is_ok_or_skipped(arch, mesh_kind, variant):
    """No cell errors: each is ``ok`` or ``skipped`` with a reason naming a
    ROADMAP item (JAX's long_500k skip names its design note)."""
    for shape in get_arch(arch).SHAPES:
        rec = _run(arch, shape, mesh_kind, variant)
        assert rec["status"] in ("ok", "skipped"), (shape, rec.get("traceback"))
        if rec["status"] == "skipped":
            assert "ROADMAP.md Queue 1, item" in rec["skip_reason"] or \
                "DESIGN.md" in rec["skip_reason"], rec["skip_reason"]
        else:
            assert rec["memory"]["argument_size_in_bytes"] > 0
            assert rec["roofline"]["bound_s"] > 0


def test_cli_report_and_profiler(tmp_path, capsys):
    out = tmp_path / "dr"
    dryrun.main(["--arch", "reachability-oracle", "--mesh", "single", "--out", str(out)])
    assert "DRYRUN SUMMARY: ok=4 skipped=0 error=0" in capsys.readouterr().out
    rec = json.loads((out / "reachability-oracle__serve_1m__single.json").read_text())
    assert rec["status"] == "ok"
    report = roofline.build_report(str(out), "single")
    assert report.count("| reachability-oracle |") == 4 and "H100" in report
    dryrun.main(["--arch", "reachability-oracle", "--mesh", "single", "--out", str(out),
                 "--skip-existing"])
    trace_top.main(["--arch", "reachability-oracle", "--shape", "serve_1m"])
    text = capsys.readouterr().out
    assert "label_intersect" in text and "all-to-all" in text


def test_model_flops_of_matches_jax(tmp_path):
    """``roofline.model_flops_of`` gives JAX's numbers on the same records."""
    from repro.launch.roofline import model_flops_of as jax_model_flops

    recs = [_run("reachability-oracle", s) for s in ("serve_1m", "build_sweep")]
    recs.append(_run("gcn-cora", "ogb_products"))
    recs.append(_run("xdeepfm", "serve_bulk", variant="tp1"))
    for rec in recs:
        rec = json.loads(json.dumps(rec, default=str))
        assert roofline.model_flops_of(rec) == jax_model_flops(rec) > 0


def test_analytic_matches_jax():
    from repro.configs import get_arch as jax_arch
    from repro.launch import analytic as ja

    from repro_torch.launch import analytic as ta

    for arch in ("granite-3-2b", "deepseek-v2-lite-16b", "h2o-danube-1.8b"):
        mine, theirs = get_arch(arch).full_config(), jax_arch(arch).full_config()
        assert ta.lm_train_terms(mine, 256, 4096, 2, 16, 16) == \
            ja.lm_train_terms(theirs, 256, 4096, 2, 16, 16)
        assert ta.lm_prefill_terms(mine, 32, 32768, 16, 16) == \
            ja.lm_prefill_terms(theirs, 32, 32768, 16, 16)
        assert ta.lm_decode_terms(mine, 128, 32768, 256, 1) == \
            ja.lm_decode_terms(theirs, 128, 32768, 256, 1)


# ------------------------------------------------------- kernel meta paths


def _meta(*ts):
    return [t.to(M) for t in ts]


def _same(a, b):
    assert (tuple(a.shape), a.dtype, "meta") == (tuple(b.shape), b.dtype, b.device.type)


def test_meta_outputs_have_the_plain_versions_shapes():
    """Each wrapper on ``meta`` gives the plain version's shapes and dtypes,
    records its cost and launches nothing."""
    g = torch.Generator().manual_seed(0)
    ri = lambda *s, hi=10: torch.randint(-1, hi, s, generator=g, dtype=torch.int32)  # noqa: E731
    ops.reset_launches()
    ops.reset_meta_cost()
    L_out, L_in, q = ri(10, 8), ri(10, 4), torch.randint(0, 10, (5, 2), generator=g,
                                                          dtype=torch.int32)
    _same(ref.tier_intersect_ref(L_out, L_in, q, 6), ops.tier_intersect(*_meta(L_out, L_in, q), 6))
    nbr, f = ri(7, 3, hi=9), ri(9, 2, hi=1000)
    _same(ref.frontier_or_ref(nbr, f), ops.frontier_or(*_meta(nbr, f)))
    a, x = ri(6, 1, hi=1000), ri(20, 3, hi=1000)
    _same(ref.bitset_mm_ref(a, x), ops.bitset_mm(*_meta(a, x)))
    wgt, h = torch.rand(7, 3, generator=g), torch.rand(9, 5, generator=g)
    _same(ref.ell_spmm_ref(nbr, wgt, h), ops.ell_spmm(*_meta(nbr, wgt, h)))
    table, idx = torch.rand(9, 4, generator=g), ri(5, 3, hi=9)
    _same(ref.embedding_bag_ref(table, idx), ops.embedding_bag(*_meta(table, idx)))
    dout = torch.rand(5, 4, generator=g)
    _same(ref.embedding_bag_bwd_ref(idx, dout, 9), ops.embedding_bag_bwd(*_meta(idx, dout), 9))
    for dt in (torch.float32, torch.bfloat16):
        qq, kk, vv = (torch.randn(1, 4, 16, 16, generator=g).to(dt),
                      torch.randn(1, 2, 16, 16, generator=g).to(dt),
                      torch.randn(1, 2, 16, 8, generator=g).to(dt))
        plain = ref.flash_attention_ref(qq, kk, vv, causal=True, window=None,
                                        scale=0.25, kv_len=16)
        _same(plain, ops.flash_attention(*_meta(qq, kk, vv), scale=0.25))
        o = plain.contiguous()
        for p, m in zip(ref.flash_attention_bwd_ref(qq, kk, vv, o, o, causal=True, window=None,
                                                    scale=0.25),
                        ops.flash_attention_bwd(*_meta(qq, kk, vv, o, o), scale=0.25)):
            _same(p, m)
    lens = torch.randint(0, 4, (10,), generator=g, dtype=torch.int32)
    sb = ops.ServeBatch(*_meta(L_out, L_in, lens, lens), None, [2, 4])
    codes = sb(q.numpy())
    assert (tuple(codes.shape), codes.dtype, codes.device.type) == ((5,), torch.uint8, "meta")
    assert not any(ops.LAUNCHES.values())
    assert set(ops.META_COST) >= {"label_intersect", "frontier_or", "bitset_mm", "ell_spmm",
                                  "embedding_bag", "embedding_bag_bwd", "flash_attention",
                                  "flash_attention_sm90", "flash_attention_bwd", "serve_batch"}


def test_meta_backward_through_the_functions():
    """Autograd through K4, K5 and K6 on ``meta``: their backward kernels'
    costs recorded (K5's transposed launch under ``ell_spmm_bwd``)."""
    ops.reset_meta_cost()
    q = torch.empty(2, 4, 64, 32, device=M, dtype=torch.bfloat16, requires_grad=True)
    k = torch.empty(2, 2, 64, 32, device=M, dtype=torch.bfloat16, requires_grad=True)
    ops.flash_attention(q, k, k).float().sum().backward()
    x = torch.empty(9, 5, device=M, requires_grad=True)
    nbr, w = torch.empty(7, 3, dtype=torch.int32, device=M), torch.empty(7, 3, device=M)
    nt, wt = torch.empty(9, 2, dtype=torch.int32, device=M), torch.empty(9, 2, device=M)
    ops.ell_spmm(nbr, w, x, nt, wt).sum().backward()
    t = torch.empty(9, 4, device=M, requires_grad=True)
    ops.embedding_bag(t, torch.empty(5, 3, dtype=torch.int32, device=M)).sum().backward()
    assert (q.grad.shape, x.grad.shape, t.grad.shape) == (q.shape, x.shape, t.shape)
    pairs, _ = ops.attention_pairs(64, 64, True, None)
    assert ops.META_COST["flash_attention_bwd"]["flops"] == 2 * pairs * (3 * 32 + 2 * 32) * 4 * 2
    assert ops.META_COST["flash_attention_sm90"]["flops"] == 2 * pairs * (32 + 32) * 4 * 2
    assert ops.META_COST["ell_spmm_bwd"]["flops"] == 2 * 9 * 2 * 5


@pytest.mark.parametrize("S,T,causal,window", [(16, 16, True, None), (4, 40, True, 8),
                                               (40, 40, False, 5), (1, 300, True, 64),
                                               (7, 9, False, None), (3, 3, True, 1)])
def test_attention_pairs_count_the_masks(S, T, causal, window):
    """``ops.attention_pairs``: the (query, key) pairs K4's masks keep and
    the keys some query sees, against the masks themselves."""
    qpos = np.arange(S)[:, None] + T - S
    t = np.arange(T)[None, :]
    keep = np.ones((S, T), bool)
    if causal:
        keep &= t <= qpos
    if window is not None:
        keep &= t > qpos - window
    assert ops.attention_pairs(S, T, causal, window) == (int(keep.sum()),
                                                         int(keep.any(0).sum()))


def test_head_dim_split_decode_counts_its_collectives():
    """A decode over a cache split along ``head_dim`` (granite's smoke
    config at decode_32k's shapes: 2 kv heads over 4 model ranks, 4 of 16
    dims a rank) on a (1, 4) fake mesh: each layer gathers q, k and v whole
    and the heads' output slices (4 all-gathers), and all-reduces the
    partial logits ([128, 4 heads, 32,768 keys] float32), wo's and the
    FFN's partial outputs (3); the embedding's all-reduce and the logits'
    all-gather once.  No K4 launch: the step is plain torch."""
    import torch.distributed as dist

    from repro_torch.configs import granite_3_2b, lm_cells
    from repro_torch.models import transformer as tf

    cfg = granite_3_2b.smoke_config()
    try:
        mesh = dryrun.fake_mesh((1, 4), ("data", "model"))
        cell = lm_cells.lm_cell(cfg, "granite-3-2b", "decode_32k", mesh)
        rec = dryrun.trace_cell(cell, mesh)
    finally:
        dist.destroy_process_group()
    L, B, T, d = cfg.n_layers, 128, 32768, cfg.d_model
    assert tf.cache_split(cfg, 4) == "head_dim"
    assert rec["comm_counts"] == {"c10d.allreduce_": 3 * L + 1,
                                  "c10d._allgather_base_": 4 * L + 1}
    assert rec["collectives"]["all-reduce"] == B * d * 4 + L * (B * 4 * T * 4 + 2 * B * d * 4)
    assert "flash_attention" not in rec["kernels"]


@pytest.mark.parametrize("arch,launches", [("granite-3-2b", True), ("h2o-danube-1.8b", False)])
def test_seq_split_decode_counts_its_collectives(arch, launches):
    """A decode over a cache split along its sequence (long_500k's batch of
    1 and 524,288 positions, 131,072 a rank) on a (4, 1) fake mesh, rank 0
    at the last position: each layer merges the ranks' rows by two
    all-reduces, the max of the lse ([1, 4, 1] float32) and the weighted
    outputs beside their weights ([1, 4, 1, 17]).  Granite's rank 0 holds
    all its keys (K4 once a layer, with its lse); danube's window of 32
    keeps none of rank 0's, which calls no kernel."""
    import torch.distributed as dist

    from repro_torch.configs import lm_cells

    cfg = get_arch(arch).smoke_config()
    try:
        mesh = dryrun.fake_mesh((4, 1), ("data", "model"))
        cell = lm_cells.lm_cell(cfg, arch, "long_500k", mesh, sub_quadratic=True)
        rec = dryrun.trace_cell(cell, mesh)
    finally:
        dist.destroy_process_group()
    L = cfg.n_layers
    assert rec["comm_counts"] == {"c10d.allreduce_": 2 * L}
    assert rec["collectives"]["all-reduce"] == L * (4 * 4 + 4 * 17 * 4)
    if launches:
        k4 = rec["kernels"]["flash_attention"]
        assert k4["calls"] == L
        # q, the 131,072 keys and values of 2 kv heads, out and the lse
        assert k4["bytes"] == L * (4 * 16 * 4 * 2 + 2 * 131072 * 32 * 4 + 4 * 4)
    else:
        assert "flash_attention" not in rec["kernels"]
