"""The port's memory-budgeted tier against ``repro``'s, on the CPU.

The counterparts of ``tests/test_budget.py``, each held to the JAX package
exactly on the same inputs:

  * the cut: at budget fractions 0.25, 0.5, 0.75, 0.9 and 1.0 of the full
    label bytes, ``rank_cut``, resident bytes, the truncation masks (packed
    and unpacked), ``dropped_ints`` and the cut matrices equal ``repro``'s,
    including the padded-width floor (``rank_cut`` 0 with resident bytes
    above the budget);
  * the engine: verdicts, the ``uncertain`` and ``searched`` counts,
    ``n_prefiltered`` and the tier counts on ``host``, ``dense`` and
    ``kernel`` (the kernel wrapper runs its plain version on CPU tensors)
    equal the JAX engine's, and BFS truth;
  * K1's batch form: ``ref.serve_batch_ref``'s uncertain marks equal the
    JAX engine's three-valued epilogue over the JAX prefilters and the
    Pallas kernel (interpret mode), and the masks leave fate and verdict
    as they are;
  * the controller: the hysteresis walk, the floor, ``reapply`` after
    ``refresh``, the snapshot-path reload (from a snapshot either package
    wrote) step for step as ``repro``'s; ``save_budgeted`` /
    ``load_budgeted`` across the packages both ways, and a corrupt mask's
    conservative fallback;
  * the ladder composed: quarantined + truncated rows and an injected device
    failure in one ``query_batch`` (``tests/test_chaos.py``), and ``refresh``
    clearing the quarantine.
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.api as japi
import repro.ft.inject as jinject
import repro.persist as jpersist
import repro.serve.budget as jbudget
import repro.serve.engine as jengine
from repro.graph.generators import random_dag
from repro.graph.scc import condense_to_dag
from repro.serve.planner import plan_batch as jplan_batch
from repro.serve.prefilter import apply_prefilters as japply_prefilters
import repro_torch.core.api as tapi
import repro_torch.ft.inject as tinject
import repro_torch.graph.csr as tcsr
import repro_torch.persist as tpersist
import repro_torch.serve.budget as tbudget
from repro_torch.kernels import ops, ref
from repro_torch.obs import metrics as tmetrics
from repro_torch.serve.prefilter import topo_levels
from test_serve_engine import _graph_families, _truth_matrix

FRACTIONS = (0.25, 0.5, 0.75, 0.9, 1.0)
BACKENDS = ("host", "dense", "kernel")
# the five serve-test families, and two wider graphs whose rows outgrow the
# padded floor, so the cut lands between 0 and n
GRAPHS = _graph_families(np.random.default_rng(0)) + [
    ("random_180", random_dag(180, 720, seed=9)), ("random_400", random_dag(400, 1600, seed=21))]
IDS = [name for name, _ in GRAPHS]


def _port_graph(g):
    return tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())


@pytest.fixture(scope="module")
def built():
    """(name, g, JAX CondensedOracle, port CondensedOracle) per graph."""
    return [(name, g, japi.build_oracle(g), tapi.build_oracle(_port_graph(g), device="cpu"))
            for name, g in GRAPHS]


def _queries(g, seed, n=1500):
    """Uniform pairs, the diagonal and the corners (original ids)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, g.n, size=(n, 2)).astype(np.int32)
    diag = np.arange(g.n, dtype=np.int32)
    return np.concatenate([q, np.stack([diag, diag], 1),
                           np.array([[0, g.n - 1], [g.n - 1, 0]], np.int32)])


def _same_store(js, ts, what):
    for k in ("rank_cut", "budget_bytes", "resident_bytes", "dropped_ints", "any_truncated",
              "n"):
        assert getattr(ts, k) == getattr(js, k), (what, k)
    assert np.array_equal(ts.truncated_out, js.truncated_out), what
    assert np.array_equal(ts.truncated_in, js.truncated_in), what
    for a, b in zip(ts.packed_masks(), js.packed_masks()):
        assert a.dtype == b.dtype == np.uint8 and a.tobytes() == b.tobytes(), what
    for f in ("L_out", "L_in", "out_len", "in_len", "hop_rank"):
        a, b = getattr(ts.oracle, f), getattr(js.oracle, f)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), \
            (what, f)


def _truth(g, q):
    return _truth_matrix(g.n, *g.edges())[q[:, 0], q[:, 1]]


# ------------------------------------------------------------- pure cut


def test_pack_unpack_mask_matches_jax():
    rng = np.random.default_rng(0)
    for n in (1, 7, 8, 9, 64, 301):
        mask = rng.random(n) < 0.4
        packed = tbudget.pack_mask(mask)
        assert packed.tobytes() == jbudget.pack_mask(mask).tobytes()
        assert np.array_equal(tbudget.unpack_mask(packed, n), mask)
        # np.packbits order: row i is bit 7 - (i & 7) of byte i >> 3
        i = np.arange(n)
        assert np.array_equal((packed[i >> 3] >> (7 - (i & 7))) & 1, mask)


@pytest.mark.parametrize("frac", FRACTIONS)
@pytest.mark.parametrize("gi", range(len(GRAPHS)), ids=IDS)
def test_cut_store_matches_jax(built, gi, frac):
    name, g, jco, tco = built[gi]
    full = tbudget.label_bytes(tco.oracle)
    assert full == jbudget.label_bytes(jco.oracle)
    budget = int(full * frac)
    theta = tbudget.rank_cut_for_budget(tco.oracle, budget)
    assert theta == jbudget.rank_cut_for_budget(jco.oracle, budget)
    ts = tbudget.truncate_store(tco.oracle, budget_bytes=budget)
    js = jbudget.truncate_store(jco.oracle, budget_bytes=budget)
    _same_store(js, ts, (name, frac))
    _same_store(jbudget.truncate_store(jco.oracle, rank_cut=theta),
                tbudget.truncate_store(tco.oracle, rank_cut=theta), (name, "theta"))
    if frac == 1.0:
        assert ts.rank_cut == tco.oracle.n and not ts.any_truncated and ts.dropped_ints == 0
    else:
        # the binary search meets the budget unless the padded floor exceeds it
        assert ts.resident_bytes <= budget or ts.rank_cut == 0


def test_rank_cut_errors_match_jax(built):
    _, _, jco, tco = built[0]
    with pytest.raises(ValueError, match="budget_bytes or rank_cut"):
        tbudget.truncate_store(tco.oracle)
    with pytest.raises(ValueError, match="budget_bytes or rank_cut"):
        jbudget.truncate_store(jco.oracle)


# ------------------------------------------------- engine three-valued path


def _set_both(jco, tco, budget):
    js = None if budget is None else jbudget.truncate_store(jco.oracle, budget_bytes=budget)
    ts = None if budget is None else tbudget.truncate_store(tco.oracle, budget_bytes=budget)
    jco.engine.set_budget(js)
    tco.engine.set_budget(ts)
    jco.engine.reset_stats()
    tco.engine.reset_stats()
    return js, ts


@pytest.mark.parametrize("frac", FRACTIONS)
@pytest.mark.parametrize("gi", range(len(GRAPHS)), ids=IDS)
def test_engine_under_budget_matches_jax(built, gi, frac):
    name, g, jco, tco = built[gi]
    js, ts = _set_both(jco, tco, int(tbudget.label_bytes(tco.oracle) * frac))
    q = _queries(g, gi)
    truth = _truth(g, q)
    try:
        for backend in BACKENDS:
            exp = jco.serve(q, backend=backend)
            got = tco.serve(q, backend=backend)
            assert (got == exp).all() and (got == truth).all(), (name, frac, backend)
            tb, jb = tco.engine.stats()["last_batch"], jco.engine.stats()["last_batch"]
            assert tb == jb, (name, frac, backend)
            if frac == 1.0:
                assert tb["degraded"]["uncertain"] == 0
        tsd, jsd = tco.engine.stats(), jco.engine.stats()
        assert tsd["budget"] == jsd["budget"] and tsd["degradation"] == jsd["degradation"]
        assert tsd["degradation"]["searched"] == tsd["degradation"]["uncertain"]
        # the single-query path mirrors the epilogue, counters included
        for u, v in q[:80]:
            assert tco.query(int(u), int(v)) == jco.query(int(u), int(v))
        assert tco.engine.stats()["degradation"] == jco.engine.stats()["degradation"]
    finally:
        _set_both(jco, tco, None)


def test_uncertain_shows_somewhere_and_grows_as_the_budget_shrinks(built):
    """Smaller budget -> nested uncertain sets: on a fixed query set the
    kernel backend's uncertain count is monotone non-increasing in budget
    in both packages, equal between them, and not always 0."""
    name, g, jco, tco = built[-1]
    q = _queries(g, 99, n=2500)
    counts = []
    for frac in (1.0, 0.9, 0.75, 0.5, 0.25, 0.1):
        _set_both(jco, tco, int(tbudget.label_bytes(tco.oracle) * frac))
        tco.serve(q, backend="kernel")
        jco.serve(q, backend="kernel")
        t, j = (co.engine.stats()["last_batch"]["degraded"]["uncertain"] for co in (tco, jco))
        assert t == j
        counts.append(t)
    _set_both(jco, tco, None)
    assert counts[0] == 0 and counts[-1] > 0
    assert all(a <= b for a, b in zip(counts, counts[1:])), counts


def test_stats_budget_record_and_metrics(built):
    name, g, jco, tco = built[-2]
    before = {k: tmetrics.REGISTRY.counter_value(k) for k in
              ("engine_verdict_uncertain_total",)}
    js, ts = _set_both(jco, tco, tbudget.label_bytes(tco.oracle) // 2)
    b = tco.engine.stats()["budget"]
    assert b == jco.engine.stats()["budget"]
    assert b["resident_bytes"] == ts.resident_bytes and b["rank_cut"] == ts.rank_cut
    assert b["n_truncated_rows"] == int(ts.truncated_out.sum() + ts.truncated_in.sum())
    tco.serve(_queries(g, 5), backend="kernel")
    unc = tco.engine.stats()["degradation"]["uncertain"]
    assert unc > 0
    assert tmetrics.REGISTRY.counter_value("engine_verdict_uncertain_total") == \
        before["engine_verdict_uncertain_total"] + unc
    assert tmetrics.REGISTRY.counter_value("engine_degraded_total", kind="uncertain") >= unc
    _set_both(jco, tco, None)
    assert tco.engine.stats()["budget"] is None and tco.engine.budget_store is None


# ------------------------------------------------------------ K1 batch form


def _jax_epilogue(o, store, level, widths, q):
    """The JAX engine's kernel path over the truncated store, as a mask of
    uncertain queries: its prefilters decide, the planner tiers the rest
    through the Pallas kernel (interpret mode), then the three-valued
    epilogue of ``repro.serve.engine.QueryEngine.query_batch``."""
    pf = japply_prefilters(q, o.out_len, o.in_len, level)
    out = pf.decided & pf.value
    rest_idx = np.flatnonzero(~pf.decided)
    rest = q[rest_idx]
    plan = jplan_batch(rest, o.out_len, o.in_len, widths, min_tile=256)
    for tier in plan.tiers:
        hit = np.asarray(jengine._tier_intersect(
            jnp.asarray(o.L_out), jnp.asarray(o.L_in),
            jnp.asarray(plan.padded_queries(rest, tier)), tier.width, True))
        out[rest_idx[tier.idx]] = hit[: tier.idx.size]
    unc = store.truncated_out[q[:, 0]] & store.truncated_in[q[:, 1]] & ~out
    unc &= q[:, 0] != q[:, 1]
    if level is not None:
        unc &= level[q[:, 0]] < level[q[:, 1]]
    return unc


@pytest.mark.parametrize("with_level", [True, False])
@pytest.mark.parametrize("frac", (0.25, 0.5, 0.75))
@pytest.mark.parametrize("gi", range(len(GRAPHS)), ids=IDS)
def test_serve_batch_ref_marks_equal_jax_epilogue(built, gi, frac, with_level):
    import torch

    from repro.serve.planner import tier_widths as jtier_widths

    name, g, jco, tco = built[gi]
    store = jbudget.truncate_store(jco.oracle,
                                   budget_bytes=int(jbudget.label_bytes(jco.oracle) * frac))
    o = store.oracle
    dag, comp = condense_to_dag(g)
    level = topo_levels(_port_graph(dag)) if with_level else None
    widths = jtier_widths(o.out_len, o.in_len, o.max_label_len)
    q = comp[_queries(g, gi + 40)].astype(np.int32)
    exp = _jax_epilogue(o, store, level, widths, q)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = [t(o.L_out), t(o.L_in), t(o.out_len), t(o.in_len),
            None if level is None else t(level), widths]
    masks = [t(m) for m in store.packed_masks()]
    codes = ref.serve_batch_ref(*args, t(q), *masks).numpy()
    plain = ref.serve_batch_ref(*args, t(q)).numpy()
    assert np.array_equal((codes & ops.SERVE_BATCH_UNCERTAIN) != 0, exp), (name, frac)
    assert np.array_equal(codes & ~np.uint8(ops.SERVE_BATCH_UNCERTAIN), plain)
    assert not (plain & ops.SERVE_BATCH_UNCERTAIN).any()
    # the wrapper on CPU tensors gives the same codes
    assert np.array_equal(ops.ServeBatch(*args, *masks)(q), codes)
    if store.any_truncated and frac <= 0.5:
        assert exp.any(), (name, frac)


# ------------------------------------------------------------- controller


def _walk(co, budget_mod, full, script, **pressure):
    sig = {"bytes": 0.0}
    ctl = budget_mod.BudgetController(
        co.engine, pressure=budget_mod.PressureConfig(watermark_bytes=full // 2, **pressure),
        pressure_source=lambda: sig["bytes"])
    trail = []
    for s in script:
        sig["bytes"] = float(s)
        trail.append((ctl.tick(), ctl.snapshot()))
    ctl.apply(None)
    return trail


def test_controller_hysteresis_walk_matches_jax(built):
    name, g, jco, tco = built[-2]
    full = tbudget.label_bytes(tco.oracle)
    script = [0, full, full, 0, 0, 0, 0, full, 0, 0, 0, 0]
    kw = dict(step_factor=0.5, recovery_ticks=2)
    t = _walk(tco, tbudget, full, script, **kw)
    j = _walk(jco, jbudget, full, script, **kw)
    assert t == j
    assert [a for a, _ in t][:5] == [None, "step_down", "step_down", None, "step_up"]
    assert t[2][1]["step_depth"] == 2 and t[6][1]["step_depth"] == 0
    assert t[6][1]["budget_bytes"] is None and t[-1][1]["step_depth"] == 0


def test_controller_floor_and_configured_budget_match_jax(built):
    name, g, jco, tco = built[-1]
    full = tbudget.label_bytes(tco.oracle)
    configured = full // 2
    trails = []
    for co, budget_mod in ((tco, tbudget), (jco, jbudget)):
        sig = {"bytes": float(full)}
        ctl = budget_mod.BudgetController(
            co.engine, budget_bytes=configured,
            pressure=budget_mod.PressureConfig(watermark_bytes=full // 4, step_factor=0.5,
                                               recovery_ticks=1,
                                               min_budget_bytes=configured // 4),
            pressure_source=lambda: sig["bytes"])
        trail = [ctl.snapshot()]
        while ctl.tick() == "step_down":
            trail.append(ctl.snapshot())
        assert ctl.budget_bytes == configured // 4 and ctl.tick() is None   # floored
        sig["bytes"] = 0.0
        while ctl.snapshot()["step_depth"] > 0:
            ctl.tick()
            trail.append(ctl.snapshot())
        assert ctl.budget_bytes == configured and co.engine.budget_store is not None
        trails.append(trail)
        ctl.apply(None)
    assert trails[0] == trails[1]


def test_controller_reapply_after_refresh_matches_jax(built):
    name, g, jco, tco = built[-2]
    q = _queries(g, 14, n=400)
    got = []
    for co, budget_mod in ((tco, tbudget), (jco, jbudget)):
        ctl = budget_mod.BudgetController(co.engine,
                                          budget_bytes=budget_mod.label_bytes(co.oracle) // 2)
        assert co.engine.budget_store is not None
        epoch = co.engine.epoch
        co.engine.refresh(co.oracle)                  # a publish drops the view
        assert co.engine.budget_store is None and co.engine.epoch == epoch + 1
        ctl.reapply()                                 # the governor re-asserts it
        st = co.engine.budget_store
        assert st is not None and st.any_truncated
        co.engine.reset_stats()
        got.append((co.serve(q, backend="kernel"), co.engine.stats()["last_batch"],
                    ctl.snapshot()))
        ctl.apply(None)
    (tv, tb, tsn), (jv, jb, jsn) = got
    assert (tv == jv).all() and (tv == _truth(g, q)).all()
    assert tb == jb and tsn == jsn


def test_refresh_drops_the_cached_kernel_binding_and_epoch_gauge(built):
    name, g, jco, tco = built[0]
    eng = tco.engine
    q = _queries(g, 3, n=200)
    eng.query_batch(q, backend="kernel")
    assert eng._serve_batch is not None
    eng.refresh(tco.oracle, epoch=41)
    assert eng._serve_batch is None and eng.epoch == 41
    assert tmetrics.REGISTRY.snapshot()["engine_epoch"]["values"][""] == 41
    assert (tco.serve(q, backend="kernel") == jco.serve(q, backend="kernel")).all()
    eng.refresh(tco.oracle, epoch=0)


def test_controller_retain_full_requires_snapshot(built):
    _, _, jco, tco = built[0]
    for budget_mod, co in ((tbudget, tco), (jbudget, jco)):
        with pytest.raises(ValueError, match="snapshot_path"):
            budget_mod.BudgetController(co.engine, retain_full=False)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_controller_snapshot_path_reload(built, writer, tmp_path):
    """retain_full=False: stepping back up reloads the full store through
    the port's ``load_oracle``, from a snapshot either package wrote."""
    name, g, jco, tco = built[-2]
    path = str(tmp_path / "full")
    (jpersist if writer == "repro" else tpersist).save_oracle(
        path, (jco if writer == "repro" else tco).oracle)
    ctl = tbudget.BudgetController(tco.engine, budget_bytes=tbudget.label_bytes(tco.oracle) // 2,
                                   snapshot_path=path, retain_full=False)
    st = tco.engine.budget_store
    assert st is not None and st.any_truncated
    ctl.apply(None)                                   # step up => snapshot load
    assert tco.engine.budget_store is None
    full = ctl.full_oracle()
    assert type(full).__module__ == "repro_torch.core.oracle"
    for f in ("L_out", "L_in", "out_len", "in_len", "hop_rank"):
        assert getattr(full, f).tobytes() == getattr(tco.oracle, f).tobytes()


def test_retruncate_site_span_and_metrics(built):
    from repro_torch.obs import trace

    name, g, jco, tco = built[-1]
    full = tbudget.label_bytes(tco.oracle)
    retr = tmetrics.REGISTRY.counter_value("budget_retruncations_total")
    ctl = tbudget.BudgetController(tco.engine)
    trace.TRACER.clear()
    st = ctl.apply(full // 2)
    assert tmetrics.REGISTRY.counter_value("budget_retruncations_total") == retr + 1
    snap = tmetrics.REGISTRY.snapshot()
    assert snap["budget_bytes"]["values"][""] == full // 2
    assert snap["budget_resident_bytes"]["values"][""] == st.resident_bytes
    assert any(ev.get("name") == "retruncate" for ev in trace.TRACER.events)
    with pytest.raises(tinject.SimulatedFailure):
        with tinject.active(tinject.Injector({"serve.retruncate": 0})):
            ctl.apply(full // 4)
    assert tco.engine.budget_store is st              # the failed step swapped nothing
    ctl.apply(None)
    assert tmetrics.REGISTRY.snapshot()["budget_bytes"]["values"][""] == 0


# --------------------------------------------------------------- persist


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"), ("repro_torch", "repro")],
                         ids=["repro_to_torch", "torch_to_repro"])
def test_budgeted_snapshot_across_packages(built, writer, reader, tmp_path):
    name, g, jco, tco = built[-1]
    pk = {"repro": (jpersist, jbudget, jco), "repro_torch": (tpersist, tbudget, tco)}
    wp, wb, wco = pk[writer]
    rp = pk[reader][0]
    st = wb.truncate_store(wco.oracle, budget_bytes=wb.label_bytes(wco.oracle) // 2)
    path = wp.save_budgeted(str(tmp_path / "budgeted"), st)
    back = rp.load_budgeted(path, strict=True)
    assert type(back).__module__.startswith(reader + ".")
    _same_store(st, back, (writer, reader))
    # both writers lay the same bytes down
    path2 = rp.save_budgeted(str(tmp_path / "again"), back)
    for f in sorted(os.listdir(path)):
        with open(os.path.join(path, f), "rb") as a, open(os.path.join(path2, f), "rb") as b:
            assert a.read() == b.read(), f
    # a corrupt mask block: strict raises, non-strict marks the whole side
    (mask_file,) = glob.glob(os.path.join(path, "trunc_mask_out*"))
    tinject.flip_bit(mask_file, seed=3)
    with pytest.raises(rp.CorruptSnapshotError):
        rp.load_budgeted(path, strict=True)
    with pytest.warns(UserWarning, match="trunc_mask_out"):
        back, report = rp.load_budgeted(path, strict=False)
    assert any("trunc_mask_out" in b for b in report.bad_blocks)
    assert back.truncated_out.all() and np.array_equal(back.truncated_in, st.truncated_in)
    if reader == "repro_torch":
        # serving the over-marked store is still exact, counters as JAX's
        with pytest.warns(UserWarning, match="trunc_mask_out"):
            jback, _ = jpersist.load_budgeted(path, strict=False)
        tco.engine.set_budget(back)
        jco.engine.set_budget(jback)
        q = _queries(g, 20, n=600)
        for backend in BACKENDS:
            for co in (tco, jco):
                co.engine.reset_stats()
            got, exp = tco.serve(q, backend=backend), jco.serve(q, backend=backend)
            assert (got == exp).all() and (got == _truth(g, q)).all()
            assert tco.engine.stats()["last_batch"] == jco.engine.stats()["last_batch"]
        tco.engine.set_budget(None)
        jco.engine.set_budget(None)


# --------------------------------------------------------- composed ladder


@pytest.mark.parametrize("backend", ["dense", "kernel"])
@pytest.mark.parametrize("gi", range(len(GRAPHS)), ids=IDS)
def test_quarantine_truncation_device_failure_one_batch(built, gi, backend):
    """Quarantined rows, budget-truncated rows and an injected device
    failure inside ONE ``query_batch``: verdicts, every counter and the
    batch record as the JAX engine's, verdicts equal to BFS truth."""
    import warnings

    name, g, jco, tco = built[gi]
    rng = np.random.default_rng(gi)
    q = rng.integers(0, g.n, size=(700, 2)).astype(np.int32)
    qmask = np.zeros(tco.oracle.n, dtype=bool)
    qmask[rng.integers(0, tco.oracle.n, size=max(tco.oracle.n // 4, 1))] = True
    got = []
    for co, budget_mod, inject in ((jco, jbudget, jinject), (tco, tbudget, tinject)):
        co.engine.set_budget(budget_mod.truncate_store(
            co.oracle, budget_bytes=budget_mod.label_bytes(co.oracle) // 2))
        co.engine.set_quarantine(qmask, None)
        co.engine.reset_stats()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with inject.active(inject.Injector({"serve.device_dispatch": 0})):
                v = co.engine.query_batch(q, backend=backend)
        single = [co.engine.query(int(u), int(w)) for u, w in q[:40]]
        got.append((v, co.engine.stats(), single))
        co.engine.set_quarantine(None, None)
        co.engine.set_budget(None)
    (jv, js, jsingle), (tv, ts, tsingle) = got
    assert (tv == jv).all() and (tv == _truth(g, q)).all(), name
    assert tsingle == jsingle
    assert ts["degradation"] == js["degradation"] and ts["last_batch"] == js["last_batch"]
    deg = ts["last_batch"]["degraded"]
    assert deg["quarantined"] > 0
    assert deg["searched"] == deg["quarantined"] + deg["uncertain"]


def test_refresh_clears_the_quarantine(built):
    name, g, jco, tco = built[-1]
    eng = tco.engine
    eng.set_quarantine(np.ones(tco.oracle.n, dtype=bool), None)
    q = _queries(g, 6, n=300)
    eng.reset_stats()
    eng.query_batch(q, backend="kernel")
    assert eng.degradation["searched"] > 0
    eng.refresh(tco.oracle)   # new labels supersede the load-time quarantine
    n0 = eng.degradation["searched"]
    eng.query_batch(q, backend="kernel")
    assert eng.degradation["searched"] == n0 and eng.quarantine_out is None
    eng.refresh(tco.oracle, epoch=0)
