"""The port's host batched engines against ``repro``'s: labels byte for byte.

``repro_torch``'s ``impl="wave"`` and ``impl="speculative"`` (numpy copies
of the JAX package's host engines) must give the same
``L_out``/``L_in``/``out_len``/``in_len``/``hop_rank`` bytes as the JAX
package's same impl, the same ``n_waves``, every integer of
``build_stats["speculation"]`` equal and the same ``build_stats`` key set —
on the five serve-test graph families, a mid-size random DAG, the order
variants, ``max_wave`` in {1, 2, 7, 256}, the dense-reachability analogues
and the adversarial chains of ``tests/test_build_speculative.py``.  The
label store's append/rollback/serialise/finalize sequences give equal
arrays in both packages, and ``impl="auto"`` picks ``speculative`` where
JAX does.
"""
import numpy as np
import pytest

import repro.build.engine as jengine
import repro.graph.generators as jgen
import repro.graph.scc as jscc
import repro_torch.build.engine as tengine
import repro_torch.graph.csr as tcsr
from test_build_speculative import _chain, _chain_segments
from test_serve_engine import _graph_families

FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")
IMPLS = ("wave", "speculative")


def _port(g):
    return tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())


def _dags():
    out = []
    for name, g in _graph_families(np.random.default_rng(0)):
        out.append((name, jscc.condense_to_dag(g)[0]))
    out.append(("random_dag_5000", jgen.random_dag(5000, 12000, seed=0)))
    return out


DAGS = _dags()
RANDOM_5000 = DAGS[-1][1]


def _assert_same_build(j, t, tag=""):
    """Equal label bytes, schedule length, speculation counts and key sets."""
    for f in FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, f)
        assert a.tobytes() == b.tobytes(), (tag, f)
    js, ts = j.build_stats, t.build_stats
    assert set(js) == set(ts), (tag, sorted(set(js) ^ set(ts)))
    assert set(js["stages"]) == set(ts["stages"]), tag
    for k in ("impl", "scheduler", "n_waves"):
        assert js[k] == ts[k], (tag, k)
    assert t.build_impl == j.build_impl == js["impl"], tag
    if "speculation" in js:
        jsp, tsp = js["speculation"], ts["speculation"]
        assert set(jsp) == set(tsp), tag
        for k, v in jsp.items():
            if not k.endswith("_seconds"):  # counts, the rate, the bailout flag
                assert tsp[k] == v, (tag, k, tsp[k], v)


def _both(g, **kw):
    return (jengine.build_distribution_labels(g, **kw),
            tengine.build_distribution_labels(_port(g), **kw))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name,g", DAGS, ids=[d[0] for d in DAGS])
def test_host_engine_byte_identical(name, g, impl):
    j, t = _both(g, impl=impl)
    _assert_same_build(j, t, name)
    assert t.build_stats["impl"] == impl
    # and both equal the scalar reference
    ref = tengine.build_distribution_labels(_port(g), impl="reference")
    for f in FIELDS:
        assert getattr(ref, f).tobytes() == getattr(t, f).tobytes(), (name, f)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("order_name", ["degree_product", "degree_sum", "random"])
def test_host_engine_under_order_variants(order_name, impl):
    g = jgen.random_dag(120, 360, seed=8)
    j, t = _both(g, impl=impl, order_name=order_name)
    _assert_same_build(j, t, order_name)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("max_wave", [1, 2, 7, 256])
def test_host_engine_max_wave(max_wave, impl):
    j, t = _both(RANDOM_5000, impl=impl, max_wave=max_wave)
    _assert_same_build(j, t, f"max_wave={max_wave}")


def test_bitset_is_an_alias_of_wave():
    g = jgen.layered_dag(80, avg_out=2.5, seed=2)
    j, t = _both(g, impl="bitset")
    _assert_same_build(j, t, "bitset")
    assert t.build_stats["impl"] == "wave"


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name,scale", [("citeseerx", 0.0008), ("cit-Patents", 0.001)])
def test_host_engine_dense_analogues(name, scale, impl):
    g = jgen.paper_dataset_analogue(name, scale=scale, seed=7)
    j, t = _both(g, impl=impl)
    _assert_same_build(j, t, name)
    if impl == "speculative":
        st = t.build_stats["speculation"]
        assert st["spec_waves"] > 0 and st["violations"] > 0
        assert not st["scalar_bailout"]


def test_adversarial_chain():
    n = 128
    g = _chain(n)
    order = np.arange(n)
    j, t = _both(g, order=order, impl="speculative")
    _assert_same_build(j, t, "chain")
    st = t.build_stats["speculation"]
    assert st["violations"] == st["spec_members"] - st["spec_waves"]
    assert not st["scalar_bailout"]


def test_scalar_bailout_chain():
    n, seg = 2304, 32
    g = _chain_segments(n, seg)
    order = np.arange(n)
    j, t = _both(g, order=order, impl="speculative")
    _assert_same_build(j, t, "chain-segments")
    assert t.build_stats["speculation"]["scalar_bailout"]
    assert t.build_stats["speculation"]["spec_members"] < n


@pytest.mark.parametrize("name,scale", [("citeseer", 0.01), ("citeseerx", 0.0008)])
def test_auto_resolves_to_speculative(name, scale):
    g = jgen.paper_dataset_analogue(name, scale=scale)
    if name == "citeseer":
        g = jscc.condense_to_dag(g)[0]
    j, t = _both(g, impl="auto")
    assert j.build_impl == t.build_impl == "speculative"
    assert "auto_wanted" not in t.build_stats
    _assert_same_build(j, t, name)


# ---------------------------------------------------------------------------
# _LabelStore: the same append/rollback sequences in both packages
# ---------------------------------------------------------------------------


def _store_pair(n, deep_cap, null):
    return (jengine._LabelStore(n, deep_cap=deep_cap, null=null),
            tengine._LabelStore(n, deep_cap=deep_cap, null=null))


def _assert_same_store(js, ts, tag=""):
    ja, ta = js.to_arrays(), ts.to_arrays()
    assert set(ja) == set(ta), tag
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and ja[k].tobytes() == ta[k].tobytes(), (tag, k)
    assert list(js.deep) == list(ts.deep) and js.deep == ts.deep, tag
    for u in range(js.n):
        assert np.array_equal(js.row(u), ts.row(u)), (tag, u)
    assert js.finalize().tobytes() == ts.finalize().tobytes(), tag


def _apply(stores, op, *args):
    for s in stores:
        getattr(s, op)(*(a.copy() for a in args))


def test_labelstore_rollback_restores_watermark():
    stores = _store_pair(4, 8, 9)
    v = np.array([0, 2], dtype=np.int64)
    _apply(stores, "append", v, np.array([3, 2]), np.array([1, 2, 3, 4, 5], dtype=np.int32))
    marks = stores[0].lens[v].copy()
    _apply(stores, "append", v, np.array([2, 4]), np.arange(10, 16, dtype=np.int32))
    _assert_same_store(*stores, "appended")
    _apply(stores, "rollback", v, marks)
    _assert_same_store(*stores, "rolled back")
    for u in range(4):
        assert (stores[1].mat[u, stores[1].lens[u]:] == 9).all(), u


def test_labelstore_rollback_across_deep_boundary():
    stores = _store_pair(2, 4, 7)
    v = np.array([0], dtype=np.int64)
    _apply(stores, "append", v, np.array([3]), np.arange(3, dtype=np.int32))
    mark = stores[0].lens[v].copy()
    _apply(stores, "append", v, np.array([6]), np.arange(10, 16, dtype=np.int32))
    _assert_same_store(*stores, "into the deep tail")
    assert 0 in stores[1].deep
    _apply(stores, "rollback", v, mark)
    _assert_same_store(*stores, "out of the deep tail")
    assert 0 not in stores[1].deep
    _apply(stores, "append", v, np.array([6]), np.arange(20, 26, dtype=np.int32))
    _apply(stores, "rollback", v, np.array([6], dtype=np.int32))
    _assert_same_store(*stores, "partial rollback")
    assert len(stores[1].deep[0]) == 2
    # the checkpoint round trip keeps the deep tail
    restored = tengine._LabelStore.from_arrays(
        stores[1].to_arrays(),
        {"store_n": 2, "store_deep_cap": 4, "store_null": 7})
    _assert_same_store(stores[0], restored, "round trip")


def test_labelstore_rollback_to_empty():
    stores = _store_pair(3, 8, 5)
    v = np.array([1], dtype=np.int64)
    _apply(stores, "append", v, np.array([4]), np.arange(4, dtype=np.int32))
    _apply(stores, "rollback", v, np.zeros(1, dtype=np.int32))
    _assert_same_store(*stores, "empty")
    assert stores[1].lens[1] == 0 and (stores[1].mat[1] == 5).all()


def test_labelstore_random_sequence(rng):
    """Random appends (growth past the head width and DEEP_CAP), rollbacks
    and prune gathers: every state and gather equal across the packages."""
    n, null = 40, 40
    stores = _store_pair(n, 16, null)
    hop = rng.integers(0, 2**63, size=(n + 1, 1), dtype=np.uint64)
    hop[null] = 0
    mark = rng.random(n + 1) < 0.2
    mark[null] = False
    for step in range(60):
        verts = np.unique(rng.choice(n, size=int(rng.integers(1, 12)), replace=False))
        counts = rng.integers(1, 6, size=verts.shape[0]).astype(np.int64)
        vals = rng.integers(0, n, size=int(counts.sum())).astype(np.int32)
        _apply(stores, "append", verts.astype(np.int64), counts, vals)
        if step % 3 == 2:
            back = np.unique(rng.choice(n, size=5, replace=False)).astype(np.int64)
            lens = stores[0].lens[back]
            marks = (lens * rng.random(back.shape[0])).astype(np.int32)
            _apply(stores, "rollback", back, marks)
        front = np.unique(rng.choice(n, size=10, replace=False)).astype(np.int64)
        assert np.array_equal(stores[0].pruned_or(front, hop),
                              stores[1].pruned_or(front, hop)), step
        assert np.array_equal(stores[0].pruned_any(front, mark),
                              stores[1].pruned_any(front, mark)), step
        jv, jl = stores[0].ragged_entries(front)
        tv, tl = stores[1].ragged_entries(front)
        assert np.array_equal(jv, tv) and np.array_equal(jl, tl), step
    assert stores[1].deep, "the sequence never reached the deep tail"
    _assert_same_store(*stores, "random sequence")


def test_build_counts_tool_agrees_at_a_cut_scale(capsys):
    """``tools/build_counts.py`` (the origin check of ``chip_smoke.py``'s
    counts) builds with both packages and reports them equal."""
    import importlib.util
    import json
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "build_counts.py"
    spec = importlib.util.spec_from_file_location("build_counts", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--scale", "0.01", "--impl", "auto", "wave"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["package"], r["asked"]) for r in recs] == [
        ("repro", "auto"), ("repro_torch", "auto"), ("repro", "wave"), ("repro_torch", "wave")]
    assert all(r["equal_to_repro"] for r in recs[1::2]), recs
    assert recs[0]["impl"] == "speculative" and recs[2]["n_waves"] > recs[0]["n_waves"]
