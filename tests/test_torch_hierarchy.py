"""The port's Hierarchical-Labeling against ``repro``'s, on the CPU.

On the same inputs, each held to the JAX package exactly:

  * the one-side backbone (``fast_cover``'s V*, E*'s CSR arrays and the
    local id map) and ``decompose`` (level sizes, ``to_global``, every
    level's CSR) on the condensations of the five serve-test families;
  * HL's labels byte for byte (``L_out``/``L_in`` ``.tobytes()`` and the
    lengths) on those families with ``core_max`` 8, 16 and 1,024, with the
    Formula 3 core, and at citeseer@0.01 and @0.05; the k-hop and
    batched-union helpers it runs on;
  * ``core_labels_formula3``;
  * an HL oracle served through ``build_oracle(method="hierarchical")`` on
    ``host``, ``dense`` and ``kernel`` (the kernel wrapper runs its plain
    version on CPU tensors): verdicts, ``n_prefiltered`` and the tier counts
    equal the JAX engine's, and BFS truth;
  * an HL oracle under ``truncate_store`` at 0.5 and 0.75 of its bytes:
    the cut store, verdicts and the uncertain/searched counts;
  * an HL snapshot (no ``hop_rank``) loaded across the packages both ways.
"""
import numpy as np
import pytest

import repro.build.traverse as jtraverse
import repro.core.api as japi
import repro.core.backbone as jbackbone
import repro.core.hierarchy as jhier
import repro.persist as jpersist
import repro.serve.budget as jbudget
from repro.graph.generators import paper_dataset_analogue as jdataset
from repro.graph.scc import condense_to_dag as jcondense
import repro_torch.build.traverse as ttraverse
import repro_torch.core.api as tapi
import repro_torch.core.backbone as tbackbone
import repro_torch.core.hierarchy as thier
import repro_torch.graph.csr as tcsr
import repro_torch.persist as tpersist
import repro_torch.serve.budget as tbudget
from test_serve_engine import _graph_families, _truth_matrix

FAMILIES = _graph_families(np.random.default_rng(0))
FAM_IDS = [name for name, _ in FAMILIES]
DAGS = [(name, jcondense(g)[0]) for name, g in FAMILIES]
BACKENDS = ("host", "dense", "kernel")
FIELDS = ("L_out", "L_in", "out_len", "in_len")


def _port_graph(g):
    return tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())


def _same_graph(a, b, what):
    assert a.n == b.n, what
    assert a.indptr.dtype == b.indptr.dtype and a.indptr.tobytes() == b.indptr.tobytes(), what
    assert a.indices.dtype == b.indices.dtype and a.indices.tobytes() == b.indices.tobytes(), what


def _same_labels(a, b, what):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), \
            (what, f)
    assert a.hop_rank is None and b.hop_rank is None, what


def _queries(g, seed, n=1500):
    """Uniform pairs, the diagonal and the corners (original ids)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, g.n, size=(n, 2)).astype(np.int32)
    diag = np.arange(g.n, dtype=np.int32)
    return np.concatenate([q, np.stack([diag, diag], 1),
                           np.array([[0, g.n - 1], [g.n - 1, 0]], np.int32)])


# ------------------------------------------------------------- backbone


@pytest.mark.parametrize("fam", range(len(DAGS)), ids=FAM_IDS)
def test_one_side_backbone_matches_jax(fam):
    name, dag = DAGS[fam]
    tdag = _port_graph(dag)
    assert np.array_equal(tbackbone.fast_cover(tdag), jbackbone.fast_cover(dag)), name
    jb, tb = jbackbone.one_side_backbone(dag), tbackbone.one_side_backbone(tdag)
    assert tb.vstar.dtype == jb.vstar.dtype and np.array_equal(tb.vstar, jb.vstar), name
    assert tb.local_of == jb.local_of, name
    _same_graph(tb.graph, jb.graph, name)


@pytest.mark.parametrize("core_max", [8, 16])
@pytest.mark.parametrize("fam", range(len(DAGS)), ids=FAM_IDS)
def test_decompose_matches_jax(fam, core_max):
    name, dag = DAGS[fam]
    jh, th = jhier.decompose(dag, core_max=core_max), thier.decompose(_port_graph(dag),
                                                                     core_max=core_max)
    assert th.h == jh.h and [lv.n for lv in th.levels] == [lv.n for lv in jh.levels], name
    for a, b in zip(th.to_global, jh.to_global):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for a, b in zip(th.levels, jh.levels):
        _same_graph(a, b, name)
    assert [bb.local_of for bb in th.backbones] == [bb.local_of for bb in jh.backbones]


@pytest.mark.parametrize("fam", range(len(DAGS)), ids=FAM_IDS)
def test_traverse_helpers_match_jax(fam):
    name, dag = DAGS[fam]
    tdag = _port_graph(dag)
    for v in range(dag.n):
        for k in (1, 2, 3):
            assert ttraverse.khop_out(tdag, v, k) == jtraverse.khop_out(dag, v, k), (name, v, k)
    rng = np.random.default_rng(fam)
    keys = rng.integers(0, 9, 300)
    vals = rng.integers(0, dag.n, 300)
    got = ttraverse.batched_union_rows(keys, vals, 9, dag.n)
    exp = jtraverse.batched_union_rows(keys, vals, 9, dag.n)
    assert len(got) == len(exp) == 9
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b), name


# ------------------------------------------------------------ HL labels


@pytest.mark.parametrize("core_max", [8, 16, 1024])
@pytest.mark.parametrize("fam", range(len(DAGS)), ids=FAM_IDS)
def test_hl_labels_byte_equal(fam, core_max):
    name, dag = DAGS[fam]
    exp = jhier.hierarchical_labeling(dag, core_max=core_max)
    got = thier.hierarchical_labeling(_port_graph(dag), core_max=core_max, device="cpu")
    _same_labels(got, exp, (name, core_max))
    st = got.build_stats
    assert st["impl"] == "hierarchical"
    assert st["level_sizes"] == [lv.n for lv in jhier.decompose(dag, core_max=core_max).levels]
    assert set(st["stages"]) == {"decompose", "core", "levelwise"}


@pytest.mark.parametrize("fam", range(len(DAGS)), ids=FAM_IDS)
def test_hl_formula3_core_byte_equal(fam):
    name, dag = DAGS[fam]
    exp = jhier.hierarchical_labeling(dag, core_max=16, core_method="formula3")
    got = thier.hierarchical_labeling(_port_graph(dag), core_max=16, core_method="formula3",
                                      device="cpu")
    _same_labels(got, exp, name)


@pytest.mark.parametrize("scale", [0.01, 0.05])
def test_hl_labels_byte_equal_at_citeseer(scale):
    dag = jcondense(jdataset("citeseer", scale=scale))[0]
    exp = jhier.hierarchical_labeling(dag)
    got = thier.hierarchical_labeling(_port_graph(dag), device="cpu")
    _same_labels(got, exp, scale)
    assert len(got.build_stats["level_sizes"]) >= 2   # a real decomposition


@pytest.mark.parametrize("fam", range(len(DAGS)), ids=FAM_IDS)
def test_core_labels_formula3_matches_jax(fam):
    name, dag = DAGS[fam]
    for eps in (2, 3):
        assert thier.core_labels_formula3(_port_graph(dag), eps) == \
            jhier.core_labels_formula3(dag, eps), (name, eps)


# -------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def built():
    """(name, g, JAX CondensedOracle, port CondensedOracle) per family, HL
    with a small core so every family decomposes."""
    return [(name, g, japi.build_oracle(g, method="hierarchical", core_max=16),
             tapi.build_oracle(_port_graph(g), method="hierarchical", core_max=16,
                               device="cpu"))
            for name, g in FAMILIES]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fam", range(len(FAMILIES)), ids=FAM_IDS)
def test_hl_served_matches_jax_engine(built, fam, backend):
    name, g, jco, tco = built[fam]
    _same_labels(tco.oracle, jco.oracle, name)
    q = _queries(g, fam)
    exp = jco.serve(q, backend=backend)
    got = tco.serve(q, backend=backend)
    assert (got == exp).all(), (name, backend, int((got != exp).sum()))
    assert tco.engine.stats()["last_batch"] == jco.engine.stats()["last_batch"]
    truth = _truth_matrix(g.n, *g.edges())[q[:, 0], q[:, 1]]
    assert (got == truth).all()
    for u, v in q[:200]:
        assert tco.query(int(u), int(v)) == jco.query(int(u), int(v))


@pytest.mark.parametrize("frac", [0.5, 0.75])
@pytest.mark.parametrize("fam", range(len(FAMILIES)), ids=FAM_IDS)
def test_hl_under_budget_matches_jax(built, fam, frac):
    name, g, jco, tco = built[fam]
    budget = int(tbudget.label_bytes(tco.oracle) * frac)
    js = jbudget.truncate_store(jco.oracle, budget_bytes=budget)
    ts = tbudget.truncate_store(tco.oracle, budget_bytes=budget)
    assert ts.rank_cut == js.rank_cut and ts.resident_bytes == js.resident_bytes
    assert ts.dropped_ints == js.dropped_ints
    assert np.array_equal(ts.truncated_out, js.truncated_out)
    assert np.array_equal(ts.truncated_in, js.truncated_in)
    _same_labels(ts.oracle, js.oracle, (name, frac))
    jco.engine.set_budget(js)
    tco.engine.set_budget(ts)
    jco.engine.reset_stats()
    tco.engine.reset_stats()
    try:
        q = _queries(g, fam + 7)
        truth = _truth_matrix(g.n, *g.edges())[q[:, 0], q[:, 1]]
        for backend in BACKENDS:
            exp = jco.serve(q, backend=backend)
            got = tco.serve(q, backend=backend)
            assert (got == exp).all() and (got == truth).all(), (name, frac, backend)
            assert tco.engine.stats()["last_batch"] == jco.engine.stats()["last_batch"]
        td, jd = tco.engine.stats(), jco.engine.stats()
        assert td["degradation"] == jd["degradation"] and td["budget"] == jd["budget"]
        assert td["degradation"]["searched"] == td["degradation"]["uncertain"]
    finally:
        jco.engine.set_budget(None)
        tco.engine.set_budget(None)


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"), ("repro_torch", "repro")],
                         ids=["repro_to_torch", "torch_to_repro"])
def test_hl_snapshot_across_packages(built, writer, reader, tmp_path):
    """An HL snapshot has no ``hop_rank`` block; either package loads the
    other's byte for byte, and the cold-started engine answers as the JAX
    engine over the same labels."""
    pkgs = {"repro": (jpersist, japi), "repro_torch": (tpersist, tapi)}
    name, g, jco, tco = built[2]
    oracles = {"repro": jco.oracle, "repro_torch": tco.oracle}
    path = pkgs[writer][0].save_oracle(str(tmp_path / "hl"), oracles[writer], row_block=16)
    loaded = pkgs[reader][0].load_oracle(path)
    _same_labels(loaded, oracles[writer], (writer, reader))
    assert type(loaded).__module__.startswith(reader + ".")
    kw = {"device": "cpu"} if reader == "repro_torch" else {}
    graph = _port_graph(g) if reader == "repro_torch" else g
    cold = pkgs[reader][1].oracle_from_snapshot(graph, path, **kw)
    q = _queries(g, 5)
    for backend in BACKENDS:
        assert (cold.serve(q, backend=backend) == jco.serve(q, backend=backend)).all()


def test_build_counts_tool_hierarchical_agrees_at_a_cut_scale(capsys):
    """``tools/build_counts.py --method hierarchical`` (the origin of
    ``chip_smoke.py``'s ``HL_*`` constants) labels with both packages and
    reports the same levels, shapes, label ints and sha256."""
    import importlib.util
    import json
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "build_counts.py"
    spec = importlib.util.spec_from_file_location("build_counts", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--method", "hierarchical", "--scale", "0.01"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["package"] for r in recs] == ["repro", "repro_torch"]
    assert recs[1]["equal_to_repro"], recs
    keys = ("level_sizes", "shape_out", "shape_in", "label_ints", "sha256")
    assert {k: recs[0][k] for k in keys} == {k: recs[1][k] for k in keys}
    assert recs[0]["level_sizes"][0] == recs[0]["n"] and len(recs[0]["sha256"]) == 64
