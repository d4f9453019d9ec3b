"""The port's dynamic oracle against ``repro``'s, on the CPU.

Every test of ``tests/test_dynamic.py`` about the dynamic oracle is restated
for ``repro_torch.dynamic`` (the benchmark gate and the deprecated
``core.query`` shim have no counterpart in the port), then differential
tests hold the port to ``repro`` on the same inputs, made with numpy from a
seed:

  * after every publish the labels (``L_out``/``L_in`` ``.tobytes()``,
    lengths, ``hop_rank``), ``level``, ``comp``, ``growth_log`` and every
    ``ApplyStats`` equal ``repro``'s on the five serve-test families, for
    repair publishes, rebuild publishes, and SCC merges and splits;
  * verdicts on ``host``, ``dense`` and ``kernel`` (the plain versions) and
    on pinned epochs (``device=True`` and ``device=False``) equal;
  * the two hypothesis draws that ``tests/test_dynamic.py``'s harness gets
    wrong, given as ORDERED batches, equal BFS truth in both packages;
  * ``generate_trace`` / ``replay`` give the same trace and counts;
  * a durable state dir written by either package recovers in the other.

``UpdateBatch.of`` applies every insert before every delete.  Where one edge
is both deleted and inserted in a batch, the tests build the ordered
``UpdateBatch`` themselves, so the oracle sees the updates in the order the
mirror applies them.
"""
import os
import shutil

import numpy as np
import pytest

import repro.dynamic as jdyn
import repro.dynamic.delta as jdelta
import repro_torch.dynamic as tdyn
import repro_torch.graph.csr as tcsr
from repro.graph.generators import layered_dag
from repro_torch.core.api import build_oracle
from repro_torch.graph.generators import layered_dag as tlayered_dag
from repro_torch.graph.generators import random_dag as trandom_dag
from mesh_ranks import one_rank_mesh
from test_dynamic import _graph_families, _mirror, _truth_matrix

HOST_BACKENDS = ("host", "dense", "kernel")
LABEL_FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")
FAMILY_NAMES = [name for name, _ in _graph_families(np.random.default_rng(0))]
PKG = {"repro": jdyn, "repro_torch": tdyn}
KW = {"repro": {}, "repro_torch": {"device": "cpu"}}


def _port_graph(g):
    return tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())


def _family(name, seed=0):
    """Family ``name`` of ``_graph_families`` drawn from ``seed``: (JAX graph,
    port graph, the rng after the draw)."""
    rng = np.random.default_rng(seed)
    g = dict(_graph_families(rng))[name]
    return g, _port_graph(g), rng


def _ordered_interleaving(g, adj, rng, n_updates, insert_frac=0.55):
    """``test_dynamic._random_interleaving``, draw for draw, returning the
    updates in the order it applied them to the mirror."""
    ups = []
    n = g.n
    for _ in range(n_updates):
        if rng.random() < insert_frac:
            a, b = int(rng.integers(0, n)), int(rng.integers(0, n))
            if a != b and b not in adj[a]:
                ups.append((True, a, b))
                adj[a].add(b)
        else:
            cands = [(u, w) for u in range(n) for w in adj[u]]
            if cands:
                e = cands[int(rng.integers(0, len(cands)))]
                ups.append((False, e[0], e[1]))
                adj[e[0]].discard(e[1])
    return ups


def _batch(pkg, ups):
    m = PKG[pkg]
    return m.UpdateBatch(tuple(m.EdgeUpdate(ins, u, v) for ins, u, v in ups))


def _edges_of(adj):
    src = [u for u in range(len(adj)) for _ in adj[u]]
    dst = [w for u in range(len(adj)) for w in adj[u]]
    return src, dst


def _assert_same_state(j, t, what):
    jo, to = j._base_oracle, t._base_oracle
    for f in LABEL_FIELDS:
        a, b = getattr(jo, f), getattr(to, f)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), \
            (what, f)
    assert np.array_equal(j.level, t.level), (what, "level")
    assert j.delta.comp.tobytes() == t.delta.comp.tobytes(), (what, "comp")
    assert j.growth_log == t.growth_log, (what, "growth_log")
    assert j.epochs == t.epochs and j.epoch == t.epoch, what
    assert (j.rebuild_count, j.repair_count) == (t.rebuild_count, t.repair_count), what
    for e in j.epochs:
        a, b = j.snapshot(e), t.snapshot(e)
        assert a.comp.tobytes() == b.comp.tobytes() and a.level.tobytes() == b.level.tobytes()
        for f in ("L_out", "L_in"):
            assert getattr(a.oracle, f).tobytes() == getattr(b.oracle, f).tobytes(), (what, e)


# ---------------------------------------------------------------------------
# tests/test_dynamic.py, restated for the port
# ---------------------------------------------------------------------------


def test_dynamic_matches_rebuild_all_families(rng):
    """<=50 random inserts/deletes per family; answers == fresh rebuild
    (checked against BFS truth AND a from-scratch build_oracle) for every
    backend."""
    for name, g in _graph_families(rng):
        tg = _port_graph(g)
        dyn = tdyn.DynamicOracle(tg, device="cpu")
        adj = _mirror(g)
        for _ in range(5):
            dyn.apply(_batch("repro_torch", _ordered_interleaving(g, adj, rng, 10)))
            dyn.publish()
        truth = _truth_matrix(g.n, adj)
        fresh = build_oracle(tcsr.from_edges(g.n, *_edges_of(adj)), device="cpu")
        q = rng.integers(0, g.n, size=(1500, 2)).astype(np.int32)
        diag = np.arange(g.n, dtype=np.int32)
        q = np.concatenate([q, np.stack([diag, diag], 1)])
        exp = truth[q[:, 0], q[:, 1]]
        assert (fresh.serve(q) == exp).all(), name
        for be in HOST_BACKENDS:
            pred = dyn.serve(q, backend=be)
            assert (pred == exp).all(), (name, be, int((pred != exp).sum()))


def test_repair_path_actually_engages():
    g = tlayered_dag(400, avg_out=2.0, seed=5)
    dyn = tdyn.DynamicOracle(g, staleness_budget=100.0, max_cone_frac=1.0, device="cpu")
    trace = tdyn.generate_trace(g, rounds=3, updates_per_round=20,
                                queries_per_round=50, dag_preserving=True, seed=7)
    stats = tdyn.replay(dyn, trace, backend="host")
    assert stats.repaired > 0
    assert stats.rebuilds == 0
    assert stats.structural == 0
    assert stats.epochs == 3


# the two hypothesis draws of tests/test_dynamic.py::test_dynamic_equivalence_property
# whose harness applies a delete and a re-insert of one edge in drawn order
# while UpdateBatch.of puts the insert first: (family, seed, n_updates, n_batches)
ORDERED_DRAWS = [(0, 1447, 34, 1), (3, 2067, 7, 1)]


@pytest.mark.parametrize("spec", ORDERED_DRAWS, ids=lambda s: "-".join(map(str, s)))
def test_ordered_draws_equal_bfs_truth(spec):
    """Given as ordered batches, both draws answer every query as BFS truth
    in both packages; ``UpdateBatch.of`` of the same draw would end with a
    different edge set than the mirror (the harness's fault, not delta's)."""
    fam, seed, n_updates, n_batches = spec
    rng = np.random.default_rng(seed)
    name, g = _graph_families(rng)[fam]
    adj = _mirror(g)
    per_batch = max(1, n_updates // n_batches)
    batches = [_ordered_interleaving(g, adj, rng, per_batch) for _ in range(n_batches)]
    truth = _truth_matrix(g.n, adj)
    q = rng.integers(0, g.n, size=(800, 2)).astype(np.int32)
    exp = truth[q[:, 0], q[:, 1]]
    for pkg, gg in (("repro", g), ("repro_torch", _port_graph(g))):
        dyn = PKG[pkg].DynamicOracle(gg, **KW[pkg])
        for ups in batches:
            dyn.apply(_batch(pkg, ups))
            dyn.publish()
        pred = dyn.serve(q, backend="host")
        assert (pred == exp).all(), (pkg, name, int((pred != exp).sum()))
        assert [sorted(s) for s in dyn.delta.out_adj] == [sorted(s) for s in adj]
    # the draw deletes and re-inserts one edge in a batch: insert-first order
    # (UpdateBatch.of) leaves it deleted, the mirror keeps it
    cs = jdelta.CondensationState(g)
    for ups in batches:
        cs.apply(jdyn.UpdateBatch.of([(u, v) for i, u, v in ups if i],
                                     [(u, v) for i, u, v in ups if not i]))
    assert [sorted(s) for s in cs.out_adj] != [sorted(s) for s in adj]


try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:

    @st.composite
    def interleavings(draw):
        fam = draw(st.integers(0, 4))
        seed = draw(st.integers(0, 10_000))
        n_updates = draw(st.integers(1, 50))
        n_batches = draw(st.integers(1, 4))
        return fam, seed, n_updates, n_batches

    @given(interleavings())
    @settings(max_examples=20, deadline=None)
    def test_dynamic_equivalence_property(spec):
        """Any ordered interleaving of <=50 random inserts/deletes + repairs
        answers as BFS truth of the mutated graph."""
        fam, seed, n_updates, n_batches = spec
        rng = np.random.default_rng(seed)
        name, g = _graph_families(rng)[fam]
        dyn = tdyn.DynamicOracle(_port_graph(g), device="cpu")
        adj = _mirror(g)
        per_batch = max(1, n_updates // n_batches)
        for _ in range(n_batches):
            dyn.apply(_batch("repro_torch", _ordered_interleaving(g, adj, rng, per_batch)))
            dyn.publish()
        truth = _truth_matrix(g.n, adj)
        q = rng.integers(0, g.n, size=(800, 2)).astype(np.int32)
        exp = truth[q[:, 0], q[:, 1]]
        pred = dyn.serve(q, backend="host")
        assert (pred == exp).all(), (name, int((pred != exp).sum()))


def test_scc_merge_collapses_in_place():
    g = tcsr.from_edges(4, [0, 1, 2], [1, 2, 3])
    cs = tdyn.CondensationState(g)
    assert cs.n_live == 4
    ev = cs.insert(3, 0)
    assert ev.kind == "merge" and ev.structural
    assert cs.n_live == 1
    rep = int(cs.comp[0])
    assert all(int(cs.comp[v]) == rep for v in range(4))
    assert cs.dag_m() == 0
    dyn = tdyn.DynamicOracle(g, device="cpu")
    assert not dyn.query(3, 0)
    dyn.apply(tdyn.UpdateBatch.of(inserts=[(3, 0)]))
    dyn.publish()
    for u in range(4):
        for v in range(4):
            assert dyn.query(u, v), (u, v)


def test_scc_split_is_scoped():
    g = tcsr.from_edges(4, [0, 1, 1, 2, 3, 0], [1, 0, 2, 3, 2, 3])
    cs = tdyn.CondensationState(g)
    dyn = tdyn.DynamicOracle(g, device="cpu")
    cs.insert(2, 0)
    dyn.apply(tdyn.UpdateBatch.of(inserts=[(2, 0)]))
    dyn.publish()
    assert cs.n_live == 1
    assert dyn.query(3, 1)
    ev = cs.delete(2, 0)
    assert ev.kind == "split" and ev.structural
    assert cs.n_live >= 2
    dyn.apply(tdyn.UpdateBatch.of(deletes=[(2, 0)]))
    dyn.publish()
    assert dyn.query(1, 2) and not dyn.query(2, 0)


def test_dag_edge_multiplicity():
    g2 = tcsr.from_edges(4, [0, 1, 0, 1], [1, 0, 2, 2])
    cs = tdyn.CondensationState(g2)
    c01, c2 = int(cs.comp[0]), int(cs.comp[2])
    assert int(cs.comp[1]) == c01
    assert cs.edge_mult[(c01, c2)] == 2
    assert cs.delete(0, 2).kind == "noop"
    assert cs.delete(1, 2).kind == "dag_delete"
    assert (c01, c2) not in cs.edge_mult


def test_epoch_pinning_and_retention():
    g = tcsr.from_edges(5, [0, 1], [1, 2])
    dyn = tdyn.DynamicOracle(g, keep_epochs=3, device="cpu")
    e0 = dyn.epoch
    assert dyn.query(0, 2) and not dyn.query(0, 3)
    dyn.apply(tdyn.UpdateBatch.of(inserts=[(2, 3)]))
    e1 = dyn.publish()
    assert dyn.query(0, 3)
    assert not dyn.query(0, 3, epoch=e0)
    dyn.apply(tdyn.UpdateBatch.of(deletes=[(0, 1)]))
    e2 = dyn.publish()
    assert not dyn.query(0, 3)
    assert dyn.query(0, 3, epoch=e1)
    dyn.apply(tdyn.UpdateBatch.of(inserts=[(3, 4)]))
    dyn.publish()
    with pytest.raises(KeyError):
        dyn.snapshot(e0)
    q = np.array([[0, 3], [2, 3], [0, 2]], dtype=np.int32)
    assert dyn.serve(q, epoch=e2).tolist() == [False, True, False]


def test_pinned_epoch_device_path_matches_host_merge(rng):
    """A pinned epoch's device path (K1's tier form; its plain version on
    the CPU) equals the host merge; the upload is memoized on the snapshot."""
    g = tlayered_dag(120, avg_out=2.0, seed=7)
    dyn = tdyn.DynamicOracle(g, device="cpu")
    trace = tdyn.generate_trace(g, rounds=2, updates_per_round=10,
                                queries_per_round=1, dag_preserving=True, seed=3)
    tdyn.replay(dyn, trace)
    old_epoch = dyn.epochs[0]
    snap = dyn.snapshot(old_epoch)
    assert str(snap.device) == "cpu"
    q = np.stack([rng.integers(0, g.n, 300), rng.integers(0, g.n, 300)], axis=1)
    dev = snap.query_batch(q, device=True)
    host = snap.query_batch(q, device=False)
    assert np.array_equal(dev, host)
    assert np.array_equal(dyn.serve(q, epoch=old_epoch), dev)
    lo1, li1 = snap.oracle.device_labels("cpu")
    lo2, li2 = snap.oracle.device_labels("cpu")
    assert lo1 is lo2 and li1 is li2


def test_growth_log_tracks_label_ints_per_epoch():
    g = tlayered_dag(150, avg_out=2.0, seed=11)
    dyn = tdyn.DynamicOracle(g, device="cpu")
    trace = tdyn.generate_trace(g, rounds=3, updates_per_round=8,
                                queries_per_round=1, dag_preserving=True, seed=5)
    tdyn.replay(dyn, trace)
    gl = dyn.growth_log
    assert len(gl) == dyn.epoch
    for e in gl:
        assert {"epoch", "label_ints", "appends", "drops", "rebuilt", "growth_rate"} <= set(e)
    assert gl[-1]["label_ints"] == dyn.labels.label_ints()
    ints = [e["label_ints"] for e in gl]
    for prev, e in zip(ints, gl[1:]):
        assert e["growth_rate"] == pytest.approx((e["label_ints"] - prev) / max(prev, 1),
                                                 abs=1e-5)


def test_cow_publish_reuses_clean_rows():
    g = tlayered_dag(200, avg_out=2.0, seed=3)
    dyn = tdyn.DynamicOracle(g, device="cpu")
    before = dyn.snapshot().oracle
    trace = tdyn.generate_trace(g, rounds=1, updates_per_round=5,
                                queries_per_round=1, dag_preserving=True, seed=1)
    tdyn.replay(dyn, trace)
    after = dyn.snapshot().oracle
    assert after is not before
    if after.L_out.shape == before.L_out.shape:
        same = (after.L_out == before.L_out).all(axis=1)
        assert same.sum() >= g.n - 64


def test_engine_refresh_keeps_epoch_and_widths():
    g = tlayered_dag(300, avg_out=2.0, seed=9)
    dyn = tdyn.DynamicOracle(g, device="cpu")
    eng = dyn.engine
    w0, e0 = list(eng.widths), eng.epoch
    dyn.apply(tdyn.UpdateBatch.of(inserts=[]))
    e1 = dyn.publish()
    assert eng.epoch == e1 == e0 + 1
    assert eng.widths == w0


def test_mutable_labels_roundtrip_and_tally():
    g = trandom_dag(50, 120, seed=2)
    o = build_oracle(g, device="cpu")
    labels = tdyn.MutableLabels.from_oracle(o.oracle)
    assert labels.label_ints() == o.oracle.total_label_size
    assert int(labels.tally_out.sum() + labels.tally_in.sum()) == labels.label_ints()
    v = 0
    r = int(labels.out_rows[v][0])
    assert labels.add("out", v, r) == 0
    assert labels.drop_in_set("out", v, {r}) == 1 and not labels.has("out", v, r)
    labels.add("out", v, r)
    out_d, _ = labels.take_dirty()
    assert v in out_d
    assert labels.take_dirty() == ({}, {})


def test_device_defaults_to_cuda_and_mesh_is_not_ported(tmp_path):
    """The device still defaults to CUDA.  ``mesh=`` (it took
    ``NotImplementedError`` until the multi-device modes came) goes to the
    engine, as in ``repro.dynamic``: over a mesh of one rank the oracle and
    its durable recovery serve ``sharded`` by default, with the JAX
    oracle's verdicts on a one-device mesh, before and after a publish."""
    import jax
    import torch

    g = tcsr.from_edges(3, [0], [1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdyn.DynamicOracle(g)
    jg = layered_dag(60, avg_out=2.0, seed=3)
    tg = tcsr.CSRGraph(jg.indptr.copy(), jg.indices.copy())
    q = np.random.default_rng(1).integers(0, jg.n, (700, 2)).astype(np.int32)
    jo = jdyn.DynamicOracle(jg, mesh=jax.make_mesh((1, 1), ("data", "model")))
    with one_rank_mesh() as mesh:
        to = tdyn.DurableDynamicOracle(tg, str(tmp_path / "state"), mesh=mesh, device="cpu")
        assert to.engine.backend == jo.engine.backend == "sharded"
        for be in ("sharded", "sharded_hop"):
            assert (to.serve(q, backend=be) == jo.serve(q, backend=be)).all()
        to.apply(tdyn.UpdateBatch.of(inserts=[(0, 59), (7, 41)]))
        jo.apply(jdyn.UpdateBatch.of(inserts=[(0, 59), (7, 41)]))
        assert to.publish() == jo.publish()
        assert (to.serve(q) == jo.serve(q)).all()
        back = tdyn.DurableDynamicOracle.recover(str(tmp_path / "state"), mesh=mesh,
                                                 device="cpu")
        assert back.engine.backend == "sharded"
        assert (back.serve(q, backend="sharded_hop") == jo.serve(q)).all()


# ---------------------------------------------------------------------------
# against repro, on the same inputs
# ---------------------------------------------------------------------------

# repair: DAG-preserving traces (label repair); mixed: random interleavings
# (merges, splits, deferred events, rebuild publishes); rebuild: a zero
# staleness budget, so every churning publish is a compacting rebuild
MODES = {"repair": {}, "mixed": {}, "rebuild": {"staleness_budget": 0.0}}


def _repair_batches(g, rng, k, per):
    """Updates that keep the condensation a DAG on any family: inserts
    oriented by the initial condensation's topological levels, deletes of
    edges between two SCCs."""
    from repro.serve.prefilter import topo_levels

    cs = jdelta.CondensationState(g)
    lvl = topo_levels(cs.dag_csr())[cs.comp]
    adj = _mirror(g)
    batches = []
    for _ in range(k):
        ups = []
        for _ in range(per):
            if rng.random() < 0.6:
                a, b = (int(x) for x in rng.integers(0, g.n, 2))
                if lvl[a] != lvl[b]:
                    a, b = (a, b) if lvl[a] < lvl[b] else (b, a)
                    if b not in adj[a]:
                        ups.append((True, a, b))
                        adj[a].add(b)
            else:
                cands = [(u, w) for u in range(g.n) for w in adj[u] if cs.comp[u] != cs.comp[w]]
                if cands:
                    u, w = cands[int(rng.integers(0, len(cands)))]
                    ups.append((False, u, w))
                    adj[u].discard(w)
        batches.append(ups)
    return batches


def _mode_batches(mode, g, rng, k=5, per=10):
    if mode == "repair":
        return _repair_batches(g, rng, k, per)
    adj = _mirror(g)
    return [_ordered_interleaving(g, adj, rng, per) for _ in range(k)]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_labels_equal_repro_after_every_publish(family, mode):
    g, tg, rng = _family(family, seed=11)
    j = jdyn.DynamicOracle(g, **MODES[mode])
    t = tdyn.DynamicOracle(tg, device="cpu", **MODES[mode])
    _assert_same_state(j, t, (family, mode, "epoch 0"))
    for b, ups in enumerate(_mode_batches(mode, g, rng)):
        sj, st = j.apply(_batch("repro", ups)), t.apply(_batch("repro_torch", ups))
        assert sj.__dict__ == st.__dict__, (family, mode, b)
        assert j.publish() == t.publish()
        _assert_same_state(j, t, (family, mode, b))
    if mode == "rebuild":
        assert t.rebuild_count > 1
    if mode == "repair":
        assert t.repair_count > 0


@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_verdicts_equal_repro(family):
    g, tg, rng = _family(family, seed=5)
    j, t = jdyn.DynamicOracle(g), tdyn.DynamicOracle(tg, device="cpu")
    for ups in _mode_batches("mixed", g, rng, k=4):
        j.apply(_batch("repro", ups)), t.apply(_batch("repro_torch", ups))
        j.publish(), t.publish()
    q = rng.integers(0, g.n, size=(1200, 2)).astype(np.int32)
    for be in HOST_BACKENDS:
        assert np.array_equal(j.serve(q, backend=be), t.serve(q, backend=be)), be
    assert j.epochs == t.epochs
    for e in t.epochs[:-1]:
        want = j.serve(q, epoch=e)
        assert np.array_equal(t.serve(q, epoch=e), want), e
        assert np.array_equal(t.snapshot(e).query_batch(q, device=False), want), e
    assert [t.query(int(u), int(v)) for u, v in q[:50]] == \
           [j.query(int(u), int(v)) for u, v in q[:50]]


def test_structural_events_equal_repro():
    """Reversed edges merge SCCs and deleted intra-SCC edges split them on
    the cyclic family: both packages' condensations report the same events,
    and both oracles publish the same rebuilt labels."""
    g, tg, _ = _family("cyclic", seed=0)
    j, t = jdyn.DynamicOracle(g), tdyn.DynamicOracle(tg, device="cpu")
    cj, ct = jdelta.CondensationState(g), tdyn.CondensationState(tg)
    rng = np.random.default_rng(4)
    kinds = []
    for i in range(12):
        edges = [(u, w) for u in range(g.n) for w in sorted(cj.out_adj[u])]
        cross = [e for e in edges if cj.comp[e[0]] != cj.comp[e[1]]]
        inner = [e for e in edges if cj.comp[e[0]] == cj.comp[e[1]]]
        # reversing a cross-SCC edge closes a cycle; deleting an edge inside
        # an SCC may split it
        ups = [(False, *inner[int(k)]) for k in rng.integers(len(inner), size=min(len(inner), 3))]
        if cross:
            a, b = cross[int(rng.integers(len(cross)))]
            ups.insert(i % 2, (True, b, a))
        ej, et = cj.apply(_batch("repro", ups)), ct.apply(_batch("repro_torch", ups))
        assert [e.__dict__ for e in ej] == [e.__dict__ for e in et], i
        kinds += [e.kind for e in et]
        sj, st = j.apply(_batch("repro", ups)), t.apply(_batch("repro_torch", ups))
        assert sj.__dict__ == st.__dict__, i
        assert j.publish() == t.publish()
        _assert_same_state(j, t, ("structural", i))
    assert "merge" in kinds and "split" in kinds, kinds
    assert t.rebuild_count > 1


def test_trace_and_replay_equal_repro():
    g = layered_dag(200, avg_out=2.0, seed=4)
    tg = _port_graph(g)
    kw = dict(rounds=4, updates_per_round=15, queries_per_round=300, insert_frac=0.6)
    for dag_preserving in (True, False):
        jt = jdyn.generate_trace(g, dag_preserving=dag_preserving, seed=3, **kw)
        tt = tdyn.generate_trace(tg, dag_preserving=dag_preserving, seed=3, **kw)
        assert [op.kind for op in jt] == [op.kind for op in tt]
        for a, b in zip(jt, tt):
            if a.kind == "update":
                assert [u.__dict__ for u in a.batch.updates] == \
                       [u.__dict__ for u in b.batch.updates]
            else:
                assert np.array_equal(a.queries, b.queries)
        answers = {"repro": [], "repro_torch": []}

        def keep(pkg):
            return lambda dyn, q, ans: answers[pkg].append(np.asarray(ans))

        js = jdyn.replay(jdyn.DynamicOracle(g), jt, backend="host", check_truth=keep("repro"))
        ts = tdyn.replay(tdyn.DynamicOracle(tg, device="cpu"), tt, backend="host",
                         check_truth=keep("repro_torch"))
        for f in ("n_updates", "n_queries", "repaired", "rebuilds", "structural", "epochs"):
            assert getattr(js, f) == getattr(ts, f), (dag_preserving, f)
        assert len(ts.query_latencies) == kw["rounds"]
        for a, b in zip(answers["repro"], answers["repro_torch"]):
            assert np.array_equal(a, b)


WAYS = [("repro", "repro_torch"), ("repro_torch", "repro")]


@pytest.mark.parametrize("way", WAYS, ids=["repro_to_torch", "torch_to_repro"])
def test_durable_state_dir_recovers_across_packages(way, tmp_path):
    """Snapshot + WAL written by one package (two publishes, then an
    acknowledged tail never published) recover in the other with equal
    labels, epoch and replayed records, and serve the never-crashed
    oracle's verdicts."""
    writer, reader = way
    g, tg, rng = _family("cyclic", seed=2)
    graph = {"repro": g, "repro_torch": tg}
    batches = _mode_batches("mixed", g, rng, k=3, per=8)
    d = str(tmp_path / "state")
    dur = PKG[writer].DurableDynamicOracle(graph[writer], state_dir=d, **KW[writer])
    for ups in batches[:2]:
        dur.apply(_batch(writer, ups))
        dur.publish()
    dur.apply(_batch(writer, batches[2]))       # acknowledged, never published
    del dur
    # each package recovers its own copy: a recovery publishes its replayed
    # tail, which writes to the state dir
    recs = {}
    for pkg in PKG:
        shutil.copytree(d, str(tmp_path / pkg))
        recs[pkg] = PKG[pkg].DurableDynamicOracle.recover(str(tmp_path / pkg), **KW[pkg])
    ref = PKG[reader].DynamicOracle(graph[reader], **KW[reader])
    for ups in batches:
        ref.apply(_batch(reader, ups))
    ref.publish()
    a, b = recs["repro"], recs["repro_torch"]
    assert a.recovered_records == b.recovered_records > 0
    _assert_same_state(a, b, way)
    q = rng.integers(0, g.n, size=(1500, 2)).astype(np.int32)
    assert np.array_equal(recs[reader].serve(q), ref.serve(q))
    assert np.array_equal(a.serve(q), b.serve(q))


def test_durable_files_are_byte_equal(tmp_path):
    """The same updates through either package write the same WAL and the
    same snapshot blocks and manifests."""
    g, tg, rng = _family("random_dag", seed=3)
    batches = _mode_batches("mixed", g, rng, k=2, per=6)
    dirs = {}
    for pkg, gg in (("repro", g), ("repro_torch", tg)):
        d = tmp_path / pkg
        dur = PKG[pkg].DurableDynamicOracle(gg, state_dir=str(d), **KW[pkg])
        for ups in batches:
            dur.apply(_batch(pkg, ups))
            dur.publish()
        dur.wal.close()
        dirs[pkg] = d
    names = sorted(os.listdir(dirs["repro"]))
    assert names == sorted(os.listdir(dirs["repro_torch"])) and "wal.bin" in names
    for name in names:
        a, b = dirs["repro"] / name, dirs["repro_torch"] / name
        files = sorted(os.listdir(a)) if a.is_dir() else [None]
        for f in files:
            pa, pb = (a, b) if f is None else (a / f, b / f)
            assert pa.read_bytes() == pb.read_bytes(), (name, f)


@pytest.mark.parametrize("rows_per_pass", [1, 5, 1 << 14])
def test_snapshot_arrays_in_passes_equal_repro(rows_per_pass, monkeypatch):
    """``CondensationState.to_arrays`` takes its rows in passes of
    ``persist.blocks.ROWS_PER_PASS`` (so a publish does not hold the
    interpreter lock for a whole pass over the graph); the arrays equal
    ``repro``'s byte for byte at any pass size, merges and splits included."""
    import repro_torch.persist.blocks as tblocks

    monkeypatch.setattr(tblocks, "ROWS_PER_PASS", rows_per_pass)
    for family in ("random_dag", "cyclic"):
        g, tg, rng = _family(family, seed=5)
        batches = _mode_batches("mixed", g, rng, k=2, per=8)
        states = {"repro": jdelta.CondensationState(g),
                  "repro_torch": tdyn.CondensationState(tg)}
        for ups in batches:
            for pkg, st in states.items():
                st.apply(_batch(pkg, ups))
            (ja, jm), (ta, tm) = (states[p].to_arrays() for p in ("repro", "repro_torch"))
            assert jm == tm and sorted(ja) == sorted(ta)
            for k in ja:
                assert ja[k].dtype == ta[k].dtype and ja[k].shape == ta[k].shape, (family, k)
                assert ja[k].tobytes() == ta[k].tobytes(), (family, k)


def test_publish_lock_probe_tool_runs(capsys, monkeypatch):
    """``tools/publish_lock_probe.py`` (where a publish holds the interpreter
    lock) runs on the CPU at a cut scale: one line a publish and a summary."""
    import importlib.util
    import json
    import pathlib

    import repro_torch.persist.blocks as tblocks

    # the tool sets the pass size for its process; put it back afterwards
    monkeypatch.setattr(tblocks, "ROWS_PER_PASS", tblocks.ROWS_PER_PASS)
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "publish_lock_probe.py"
    spec = importlib.util.spec_from_file_location("publish_lock_probe", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--scale", "0.01", "--device", "cpu", "--rounds", "2",
                      "--updates", "20", "--rows-per-pass", "0"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x.get("round") for x in lines[:2]] == [0, 1] and lines[-1]["summary"]
    assert lines[0]["rows_per_pass"] == "all" and lines[0]["n"] > 0
    for x in lines[:2]:
        assert x["seconds"] > 0 and set(x["gc_passes"]) == {"gen0", "gen1", "gen2"}
        assert len(x["longest"]) <= 5 and x["gaps_over"] >= len(x["longest"])
