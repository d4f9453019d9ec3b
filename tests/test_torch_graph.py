"""The port's graph substrate against ``repro``'s: same seeds, same arrays.

Generators, SCC condensation, vertex orders, topological levels and host
reachability are numpy code carried over into ``repro_torch``; they must
give byte-identical arrays for the same inputs.
"""
import numpy as np
import pytest

import repro.core.order as jorder
import repro.graph.csr as jcsr
import repro.graph.generators as jgen
import repro.graph.reach as jreach
import repro.graph.scc as jscc
import repro_torch.core.order as torder
import repro_torch.graph.csr as tcsr
import repro_torch.graph.generators as tgen
import repro_torch.graph.reach as treach
import repro_torch.graph.scc as tscc


def _same_graph(a, b):
    assert a.indptr.dtype == b.indptr.dtype and a.indices.dtype == b.indices.dtype
    assert a.indptr.tobytes() == b.indptr.tobytes()
    assert a.indices.tobytes() == b.indices.tobytes()


GENERATORS = [
    ("random_dag", dict(n=400, m=1200, seed=3)),
    ("layered_dag", dict(n=500, avg_out=2.5, seed=4)),
    ("tree_dag", dict(n=300, branching=5, seed=5)),
    ("scale_free_dag", dict(n=200, avg_out=3.0, seed=6)),
    ("chain_dag", dict(n=120, width=4, seed=7)),
]


@pytest.mark.parametrize("name,kw", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generators_identical(name, kw):
    _same_graph(getattr(jgen, name)(**kw), getattr(tgen, name)(**kw))


@pytest.mark.parametrize("dataset,scale", [
    ("kegg", 1.0), ("citeseer", 0.002), ("xmark", 0.1), ("nasa", 0.05),
    ("go_uniprot", 0.0001),
])
def test_paper_dataset_analogue_identical(dataset, scale):
    assert tgen.PAPER_DATASETS == jgen.PAPER_DATASETS
    _same_graph(jgen.paper_dataset_analogue(dataset, scale=scale),
                tgen.paper_dataset_analogue(dataset, scale=scale))


def _cyclic_edges(seed, n, m):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m)


@pytest.mark.parametrize("seed,n,m", [(0, 60, 170), (1, 200, 260), (2, 80, 30)])
def test_condense_to_dag_identical(seed, n, m):
    src, dst = _cyclic_edges(seed, n, m)
    jg, tg = jcsr.from_edges(n, src, dst), tcsr.from_edges(n, src, dst)
    _same_graph(jg, tg)
    jdag, jcomp = jscc.condense_to_dag(jg)
    tdag, tcomp = tscc.condense_to_dag(tg)
    assert jcomp.tobytes() == tcomp.tobytes()
    _same_graph(jdag, tdag)
    _same_graph(jdag.reverse(), tdag.reverse())
    assert jcsr.topo_levels(jdag).tobytes() == tcsr.topo_levels(tdag).tobytes()
    assert jcsr.topological_order(jdag).tobytes() == tcsr.topological_order(tdag).tobytes()


@pytest.mark.parametrize("order_name", ["degree_product", "degree_sum", "random"])
def test_get_order_identical(order_name):
    jg = jgen.layered_dag(600, avg_out=2.0, seed=9)
    tg = tgen.layered_dag(600, avg_out=2.0, seed=9)
    assert (jorder.get_order(jg, order_name).tobytes()
            == torder.get_order(tg, order_name).tobytes())


def test_reach_utilities_identical():
    jg = jgen.random_dag(150, 400, seed=2)
    tg = tgen.random_dag(150, 400, seed=2)
    assert (jreach.transitive_closure_bits(jg).tobytes()
            == treach.transitive_closure_bits(tg).tobytes())
    for u in (0, 17, 149):
        assert jreach.reachable_set(jg, u).tobytes() == treach.reachable_set(tg, u).tobytes()
        assert jreach.bfs_levels(jg, u).tobytes() == treach.bfs_levels(tg, u).tobytes()
    for equal in (True, False):
        jq, jt = jreach.sample_query_workload(jg, 300, np.random.default_rng(4), equal=equal)
        tq, tt = treach.sample_query_workload(tg, 300, np.random.default_rng(4), equal=equal)
        assert jq.tobytes() == tq.tobytes() and jt.tobytes() == tt.tobytes()
