"""The port's serve path against ``repro``'s QueryEngine, on the CPU.

On the five serve-test graph families, ``repro_torch``'s QueryEngine with the
``host``, ``dense`` and ``kernel`` backends (the kernel wrapper runs its
plain version on CPU tensors) must give the JAX engine's verdicts, prefilter
counts, tier stats and degradation counters exactly — both over labels the
port built itself and over JAX-built labels carried across with
``oracle_from_arrays``.  ``build_oracle(g, device="cpu").serve(q)`` must
equal BFS truth.
"""
import numpy as np
import pytest
import torch

import repro.core.api as japi
import repro.ft.inject as jinject
import repro.serve.engine as jengine
from repro.graph.scc import condense_to_dag
import repro_torch.core.api as tapi
import repro_torch.ft.inject as tinject
import repro_torch.graph.csr as tcsr
import repro_torch.serve.engine as tengine
from repro_torch.core.oracle import oracle_from_arrays
from repro_torch.serve.prefilter import topo_levels
from test_serve_engine import _graph_families, _truth_matrix

BACKENDS = ("host", "dense", "kernel")
FAMILIES = _graph_families(np.random.default_rng(0))


def _port_graph(g):
    return tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())


def _queries(g, seed):
    """Uniform pairs + the diagonal + corner ids, as the JAX serve tests."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, g.n, size=(1500, 2)).astype(np.int32)
    diag = np.arange(g.n, dtype=np.int32)
    return np.concatenate([q, np.stack([diag, diag], 1),
                           np.array([[0, g.n - 1], [g.n - 1, 0]], np.int32)])


def _batch_view(engine):
    s = engine.stats()
    return s["last_batch"], s["degradation"]


@pytest.fixture(scope="module")
def built():
    """(name, g, JAX CondensedOracle, port CondensedOracle) per family."""
    return [(name, g, japi.build_oracle(g), tapi.build_oracle(_port_graph(g), device="cpu"))
            for name, g in FAMILIES]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fam", range(len(FAMILIES)), ids=[f[0] for f in FAMILIES])
def test_engine_matches_jax_engine(built, fam, backend):
    name, g, jco, tco = built[fam]
    q = _queries(g, fam)
    exp = jco.serve(q, backend=backend)
    got = tco.serve(q, backend=backend)
    assert (got == exp).all(), (name, backend, int((got != exp).sum()))
    assert _batch_view(tco.engine) == _batch_view(jco.engine)
    truth = _truth_matrix(g.n, *g.edges())[q[:, 0], q[:, 1]]
    assert (got == truth).all()


@pytest.mark.parametrize("fam", range(len(FAMILIES)), ids=[f[0] for f in FAMILIES])
def test_engine_serves_jax_built_labels(built, fam):
    """Weights carried across: the port's engine over the JAX oracle's
    arrays answers exactly as the JAX engine over the same arrays."""
    name, g, jco, _ = built[fam]
    jo = jco.oracle
    to = oracle_from_arrays(jo.L_out, jo.L_in, jo.out_len, jo.in_len, jo.hop_rank)
    dag, comp = condense_to_dag(g)
    level = topo_levels(_port_graph(dag))
    q = comp[_queries(g, fam + 10)]
    for backend in BACKENDS:
        je = jengine.QueryEngine(jo, backend=backend, level=level)
        te = tengine.QueryEngine(to, backend=backend, level=level, device="cpu")
        assert (te.query_batch(q) == je.query_batch(q)).all(), (name, backend)
        assert _batch_view(te) == _batch_view(je)
        for u, v in q[:200]:
            assert te.query(int(u), int(v)) == je.query(int(u), int(v))


@pytest.mark.parametrize("fam", range(len(FAMILIES)), ids=[f[0] for f in FAMILIES])
def test_degradation_ladder_matches_jax(built, fam):
    """Quarantined rows, an injected device failure and a past deadline move
    the same counters by the same amounts in both engines, with the same
    verdicts."""
    name, g, jco, tco = built[fam]
    q = _queries(g, fam + 20)
    qrng = np.random.default_rng(fam)
    qo = qrng.random(jco.oracle.n) < 0.1
    qi = qrng.random(jco.oracle.n) < 0.1
    for co in (jco, tco):
        co.engine.reset_stats()
        co.engine.set_quarantine(qo, qi)
    exp = [jco.serve(q, backend="kernel")]
    got = [tco.serve(q, backend="kernel")]
    with pytest.warns(UserWarning, match="backend failed"):
        with jinject.active(jinject.Injector({"serve.device_dispatch": 0})):
            exp.append(jco.serve(q, backend="dense"))
    with pytest.warns(UserWarning, match="backend failed"):
        with tinject.active(tinject.Injector({"serve.device_dispatch": 0})):
            got.append(tco.serve(q, backend="dense"))
    exp.append(jco.serve(q, backend="kernel", deadline=0.0))
    got.append(tco.serve(q, backend="kernel", deadline=0.0))
    for co in (jco, tco):
        co.engine.set_quarantine(None, None)
    for e, t in zip(exp, got):
        assert (e == t).all(), name
    js, ts = jco.engine.stats(), tco.engine.stats()
    assert ts["degradation"] == js["degradation"]
    assert js["degradation"]["device_to_host"] > 0
    assert js["degradation"]["deadline_to_host"] > 0
    assert js["degradation"]["quarantined"] > 0
    assert set(ts) == set(js)
    assert {k: ts[k] for k in ("epoch", "widths", "n_quarantined", "budget")} == \
        {k: js[k] for k in ("epoch", "widths", "n_quarantined", "budget")}


@pytest.mark.parametrize("backend,target", [("kernel", "ops"), ("dense", "ref")])
def test_real_device_failure_raises_instead_of_degrading(built, monkeypatch, backend, target):
    """Only an injected failure takes the device -> host rung.  A real one
    (the kernel does not build, a launch fails) is raised: the port never
    serves a failed device path's sub-batch on the CPU."""
    name, g, _, tco = built[0]
    q = _queries(g, 40)

    def broken(*args, **kwargs):
        raise RuntimeError("label_intersect launch failed: CUDA error 700")

    monkeypatch.setattr(getattr(tengine, target),
                        "tier_intersect" if target == "ops" else "tier_intersect_ref", broken)
    tco.engine.reset_stats()
    with pytest.raises(RuntimeError, match="launch failed"):
        tco.serve(q, backend=backend)
    assert not any(tco.engine.stats()["degradation"].values())


def test_unbucketed_and_single_query_paths_match_jax():
    name, g = FAMILIES[0]
    q = _queries(g, 3)
    jco = japi.build_oracle(g, bucketing=False)
    tco = tapi.build_oracle(_port_graph(g), bucketing=False, device="cpu")
    for backend in BACKENDS:
        assert (tco.serve(q, backend=backend) == jco.serve(q, backend=backend)).all()
    for u, v in q[:300]:
        assert tco.query(int(u), int(v)) == jco.query(int(u), int(v))


def test_backend_selection():
    assert tengine.select_backend("auto", "cpu") == "dense"
    assert tengine.select_backend(None, "cuda") == "kernel"
    assert tengine.select_backend("host", "cuda") == "host"
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        tengine.select_backend("sharded", "cpu")
    with pytest.raises(ValueError):
        tengine.select_backend("nope", "cpu")
    co = tapi.build_oracle(tcsr.from_edges(5, [0, 1], [1, 2]), device="cpu")
    assert co.engine.backend == "dense"
    co.engine.set_budget(None)
    assert co.engine.budget_store is None
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        co.engine.set_budget(object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tapi.build_oracle(tcsr.from_edges(5, [0, 1], [1, 2]), method="hierarchical",
                          device="cpu")


def test_device_labels_memoized_per_device():
    co = tapi.build_oracle(tcsr.from_edges(5, [0, 1], [1, 2]), device="cpu")
    a = co.oracle.device_labels("cpu")
    assert a is co.oracle.device_labels("cpu")
    assert a[0] is co.engine._lo and a[1] is co.engine._li
    assert a[0].dtype == torch.int32 and a[1].dtype == torch.int32
    assert (a[0].numpy() == co.oracle.L_out).all()
