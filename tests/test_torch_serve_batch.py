"""K1's batch form (``serve_batch``) and the ``kernel`` backend built on it,
against ``repro``, on the CPU.

  * ``ref.serve_batch_ref`` (the plain version, which ``ops.ServeBatch`` runs
    on CPU tensors) equals the JAX package's pipeline on the same labels and
    queries: ``apply_prefilters``, ``plan_batch``'s tier assignment and
    ``_tier_intersect`` through the Pallas kernel in interpret mode, on the
    five serve-test graph families, over port-built labels and over JAX-built
    labels carried across with ``oracle_from_arrays``, with and without the
    level prefilter.  Exact: codes are bytes.
  * The plain version and ``ops.ServeBatch`` equal a numpy loop on the edge
    cases of ``tests/serve_batch_cases.py`` (which the card tests and
    ``chip_smoke.py`` hold the kernel to), and ``ServeBatch`` refuses a bad
    binding.
  * The ``kernel`` engine raises ``IndexError`` for an id >= n in both
    packages and gives equal verdicts for -1; an injected device failure at
    call 0 fires on the same batch in both engines when a first batch is
    prefiltered whole.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as japi
import repro.ft.inject as jinject
import repro.serve.engine as jengine
from repro.graph.scc import condense_to_dag
from repro.serve.planner import plan_batch as jplan_batch
from repro.serve.planner import tier_widths as jtier_widths
from repro.serve.prefilter import apply_prefilters as japply_prefilters
import repro_torch.core.api as tapi
import repro_torch.ft.inject as tinject
import repro_torch.graph.csr as tcsr
import repro_torch.serve.engine as tengine
from repro_torch.core.oracle import oracle_from_arrays
from repro_torch.kernels import ops, ref
from repro_torch.serve.planner import tier_widths
from repro_torch.serve.prefilter import topo_levels
from serve_batch_cases import BINDING, CASES, MASKS, UNCERTAIN, make_case, numpy_codes
from test_serve_engine import _graph_families

FAMILIES = _graph_families(np.random.default_rng(0))


def _port_graph(g):
    return tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())


@pytest.fixture(scope="module")
def built():
    """(name, g, JAX CondensedOracle, port CondensedOracle) per family."""
    return [(name, g, japi.build_oracle(g), tapi.build_oracle(_port_graph(g), device="cpu"))
            for name, g in FAMILIES]


def _condensed_queries(g, seed):
    """Uniform pairs, the diagonal and the corners, in condensation ids."""
    _, comp = condense_to_dag(g)
    rng = np.random.default_rng(seed)
    q = rng.integers(0, g.n, size=(1200, 2))
    diag = np.arange(g.n)
    q = np.concatenate([q, np.stack([diag, diag], 1), [[0, g.n - 1], [g.n - 1, 0]]])
    return comp[q].astype(np.int32)


def _jax_codes(o, level, widths, q):
    """The JAX engine's pipeline for the kernel backend, as codes: the
    prefilters decide (fate 0), the planner assigns the rest a tier, whose
    verdict the Pallas kernel (interpret mode) gives."""
    pf = japply_prefilters(q, o.out_len, o.in_len, level)
    codes = np.where(pf.decided & pf.value, 1, 0).astype(np.uint8)
    rest_idx = np.flatnonzero(~pf.decided)
    rest = q[rest_idx]
    plan = jplan_batch(rest, o.out_len, o.in_len, widths, min_tile=256)
    for tier in plan.tiers:
        hit = np.asarray(jengine._tier_intersect(
            jnp.asarray(o.L_out), jnp.asarray(o.L_in),
            jnp.asarray(plan.padded_queries(rest, tier)), tier.width, True))
        t = widths.index(tier.width)
        codes[rest_idx[tier.idx]] = 2 * (t + 1) + hit[: tier.idx.size]
    return codes


def _plain(o, level, widths, q):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    return ref.serve_batch_ref(t(o.L_out), t(o.L_in), t(o.out_len), t(o.in_len),
                               None if level is None else t(level), widths,
                               torch.from_numpy(q)).numpy()


@pytest.mark.parametrize("with_level", [True, False])
@pytest.mark.parametrize("labels", ["port", "jax"])
@pytest.mark.parametrize("fam", range(len(FAMILIES)), ids=[f[0] for f in FAMILIES])
def test_plain_version_matches_jax_pipeline(built, fam, labels, with_level):
    name, g, jco, tco = built[fam]
    jo = jco.oracle
    o = tco.oracle if labels == "port" else oracle_from_arrays(
        jo.L_out, jo.L_in, jo.out_len, jo.in_len, jo.hop_rank)
    dag, _ = condense_to_dag(g)
    level = topo_levels(_port_graph(dag)) if with_level else None
    widths = jtier_widths(o.out_len, o.in_len, o.max_label_len)
    assert widths == tier_widths(o.out_len, o.in_len, o.max_label_len)
    q = _condensed_queries(g, fam)
    exp = _jax_codes(o, level, widths, q)
    got = _plain(o, level, widths, q)
    assert got.dtype == np.uint8
    assert (got == exp).all(), (name, labels, int((got != exp).sum()))
    assert (exp >= 2).any() and (exp < 2).any(), "the check needs both fates"
    # the wrapper on CPU tensors runs the plain version and counts no launch
    sb = ops.ServeBatch(*(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
                          for a in (o.L_out, o.L_in, o.out_len, o.in_len)),
                        None if level is None else torch.from_numpy(level), widths)
    ops.reset_launches()
    assert (sb(q) == exp).all()
    assert not any(ops.LAUNCHES.values())


def _case_args(case):
    return [None if case[k] is None else torch.from_numpy(case[k]) for k in BINDING] + \
        [case["widths"]]


def _case_masks(case):
    return {k: None if case[k] is None else torch.from_numpy(case[k]) for k in MASKS}


@pytest.mark.parametrize("name", CASES)
def test_plain_version_and_wrapper_match_numpy_loop(name):
    case = make_case(np.random.default_rng(CASES.index(name)), name)
    args, masks = _case_args(case), _case_masks(case)
    sb = ops.ServeBatch(*args, **masks)
    q = case["queries"]
    if name.startswith("bad_"):
        with pytest.raises(IndexError):
            numpy_codes(case)
        with pytest.raises(IndexError, match="outside"):
            ref.serve_batch_ref(*args, torch.from_numpy(q))
        with pytest.raises(IndexError, match="outside"):
            sb(q)
        return
    exp = numpy_codes(case)
    got = ref.serve_batch_ref(*args, torch.from_numpy(q), **masks)
    assert got.dtype == torch.uint8 and got.shape == (q.shape[0],)
    assert (got.numpy() == exp).all(), int((got.numpy() != exp).sum())
    assert (sb(q) == exp).all()
    unc = (exp & UNCERTAIN) != 0
    # the masks add the mark and change no fate or verdict
    plain = ref.serve_batch_ref(*args, torch.from_numpy(q)).numpy()
    assert (exp & ~np.uint8(UNCERTAIN) == plain).all() and not (plain & UNCERTAIN).any()
    assert unc.any() == (name.startswith("mask_") and name != "mask_one_side"), name
    fates = (exp & ~np.uint8(UNCERTAIN)) >> 1
    u, v = q[:, 0].astype(np.int64) % case["L_out"].shape[0], q[:, 1] % case["L_out"].shape[0]
    if name == "mask_empty_rows":   # the emptiness prefilter's false, both rows cut
        empty = (case["out_len"][u] == 0) | (case["in_len"][v] == 0)
        assert (unc & (fates == 0) & empty).any()
    elif name == "mask_same_vertex":
        assert (u == v).any() and not unc[u == v].any()
    elif name == "mask_level_ge":
        ge = (case["level"][u] >= case["level"][v]) & (u != v)
        assert ge.any() and not unc[ge].any()
    elif name == "mask_partial_byte":   # the last byte's rows are read and marked
        assert unc[(u >= 296) & (v >= 296)].any()
    if name == "all_prefiltered":
        assert (fates == 0).all()
    elif name == "none_prefiltered":
        assert (fates > 0).all()
    elif name == "three_tiers":
        assert set(fates.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("bad", ["widths_order", "widths_zero", "widths_many", "past_len",
                                 "len_range", "level_shape", "queries_dtype", "queries_shape",
                                 "one_mask", "mask_size", "mask_dtype"])
def test_serve_batch_refuses_a_bad_binding_or_batch(bad):
    case = make_case(np.random.default_rng(0), "one")
    if bad in ("one_mask", "mask_size", "mask_dtype"):
        n = case["L_out"].shape[0]
        m = {"one_mask": np.zeros((n + 7) // 8, np.uint8),
             "mask_size": np.zeros((n + 7) // 8 + 1, np.uint8),
             "mask_dtype": np.zeros((n + 7) // 8, np.int32)}[bad]
        with pytest.raises(ValueError, match="trunc"):
            ops.ServeBatch(*_case_args(case), trunc_out=torch.from_numpy(m),
                           trunc_in=None if bad == "one_mask" else torch.from_numpy(m))
        return
    if bad == "past_len":   # a valid entry after a row's length
        row = int(np.flatnonzero(case["out_len"] < case["L_out"].shape[1])[0])
        case["L_out"][row, case["out_len"][row]] = 5
    elif bad == "len_range":
        case["in_len"][3] = case["L_in"].shape[1] + 1
    elif bad == "level_shape":
        case["level"] = case["level"][:-1]
    elif bad.startswith("widths"):
        case["widths"] = {"widths_order": [16, 8], "widths_zero": [0, 8],
                          "widths_many": list(range(8, 8 * 18, 8))}[bad]
    if not bad.startswith("queries"):
        with pytest.raises(ValueError):
            ops.ServeBatch(*_case_args(case))
        return
    sb = ops.ServeBatch(*_case_args(case))
    q = case["queries"].astype(np.int64) if bad == "queries_dtype" else case["queries"][:, :1]
    with pytest.raises(ValueError, match="queries"):
        sb(q)


@pytest.mark.parametrize("fam", range(len(FAMILIES)), ids=[f[0] for f in FAMILIES])
def test_kernel_engine_ids_out_of_range_match_jax(built, fam):
    """An id >= n raises IndexError in both packages, through the engine in
    condensation ids and through ``serve`` in original ids; -1 counts from
    the end in both, with equal verdicts and stats."""
    name, g, jco, tco = built[fam]
    jo = jco.oracle
    to = oracle_from_arrays(jo.L_out, jo.L_in, jo.out_len, jo.in_len, jo.hop_rank)
    je = jengine.QueryEngine(jo, backend="kernel")
    te = tengine.QueryEngine(to, backend="kernel", device="cpu")
    q = _condensed_queries(g, fam + 30)[:300]
    n = jo.n
    for bad in ((n, 0), (0, n)):
        qb = q.copy()
        qb[7] = bad
        for e in (je, te):
            with pytest.raises(IndexError):
                e.query_batch(qb)
    for co in (jco, tco):
        with pytest.raises(IndexError):
            co.serve(np.array([[0, g.n]], np.int32), backend="kernel")
    qn = q.copy()
    qn[::5, 0] = -1
    qn[1::5, 1] = -1
    exp, got = je.query_batch(qn), te.query_batch(qn)
    assert (got == exp).all(), (name, int((got != exp).sum()))
    # the port wraps an id before the same-vertex prefilter, JAX after it:
    # a pair (-1, n - 1) is prefiltered here and intersected there (a
    # deliberate difference, ROADMAP.md Queue 3)
    wrapped_same = int(((qn[:, 0] % n == qn[:, 1] % n) & (qn[:, 0] != qn[:, 1])).sum())
    ts, js = te.stats()["last_batch"], je.stats()["last_batch"]
    assert ts["n_prefiltered"] == js["n_prefiltered"] + wrapped_same
    for st in (ts, js):
        assert st["n_prefiltered"] + sum(t["count"] for t in st["tiers"]) == qn.shape[0]
    assert (tco.serve(np.array([[-1, 0], [0, -1]]), backend="kernel")
            == jco.serve(np.array([[-1, 0], [0, -1]]), backend="kernel")).all()


@pytest.mark.parametrize("fam", range(len(FAMILIES)), ids=[f[0] for f in FAMILIES])
def test_injected_failure_fires_on_the_same_batch_as_jax(built, fam):
    """Injector {serve.device_dispatch: 0}: a first batch that the prefilters
    decide whole dispatches nothing, so call 0 is the second batch's, in both
    engines; it is served on the host merge and counted device_to_host."""
    name, g, jco, tco = built[fam]
    diag = np.repeat(np.arange(g.n, dtype=np.int32)[:, None], 2, axis=1)
    q = np.random.default_rng(fam).integers(0, g.n, size=(900, 2)).astype(np.int32)
    res = []
    for co, inject in ((jco, jinject), (tco, tinject)):
        co.engine.reset_stats()
        with pytest.warns(UserWarning, match="backend failed"):
            with inject.active(inject.Injector({"serve.device_dispatch": 0})):
                first = co.serve(diag, backend="kernel")
                after_first = co.engine.stats()
                second = co.serve(q, backend="kernel")
                third = co.serve(q, backend="kernel")
        res.append((first, after_first, second, co.engine.stats(), third))
    (jf, js1, j2, js2, j3), (tf, ts1, t2, ts2, t3) = res
    assert jf.all() and tf.all()
    assert ts1 == js1 and js1["last_batch"]["n_prefiltered"] == g.n
    assert not any(js1["degradation"].values())
    assert (t2 == j2).all() and (t3 == j3).all(), name
    assert ts2["degradation"] == js2["degradation"]
    assert js2["degradation"]["device_to_host"] > 0
    assert ts2["last_batch"] == js2["last_batch"]
