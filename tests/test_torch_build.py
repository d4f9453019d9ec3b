"""The port's construction against ``repro``'s: labels byte for byte.

``repro_torch``'s reference Distribution-Labeling build must give the same
``L_out``/``L_in``/``out_len``/``in_len``/``hop_rank`` bytes as the JAX
package's ``reference`` and ``wave`` impls (which already agree with each
other), on the five serve-test graph families and one mid-size random DAG.
"""
import numpy as np
import pytest

import repro.build.engine as jengine
import repro.graph.generators as jgen
import repro.graph.scc as jscc
import repro_torch.build.engine as tengine
import repro_torch.graph.csr as tcsr
from repro_torch.core.oracle import oracle_from_arrays
from test_serve_engine import _graph_families

FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")


def _dags():
    """(name, JAX-side DAG, port-side DAG) over the same edges."""
    out = []
    for name, g in _graph_families(np.random.default_rng(0)):
        dag, _ = jscc.condense_to_dag(g)
        out.append((name, dag))
    out.append(("random_dag_5000", jgen.random_dag(5000, 12000, seed=0)))
    return [(name, dag, tcsr.CSRGraph(dag.indptr.copy(), dag.indices.copy()))
            for name, dag in out]


DAGS = _dags()


def _assert_same_labels(j, t):
    for f in FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("jax_impl", ["reference", "wave"])
@pytest.mark.parametrize("name,jdag,tdag", DAGS, ids=[d[0] for d in DAGS])
def test_reference_build_byte_identical(name, jdag, tdag, jax_impl):
    j = jengine.build_distribution_labels(jdag, impl=jax_impl)
    t = tengine.build_distribution_labels(tdag, impl="reference")
    _assert_same_labels(j, t)
    # the carried-across oracle holds the same bytes as both
    _assert_same_labels(j, oracle_from_arrays(*(getattr(j, f) for f in FIELDS)))


def test_auto_resolves_to_reference_and_records_it():
    g = tcsr.from_edges(6, [0, 1, 2, 3], [1, 2, 3, 4])
    o = tengine.build_distribution_labels(g, impl="auto")
    assert o.build_stats["impl"] == "reference"
    assert o.build_impl == "reference"
    assert set(o.build_stats) == {"impl", "scheduler", "schedule_seconds",
                                  "sweep_seconds", "n_waves", "stages",
                                  "stage_shares"}
    assert o.n == g.n


@pytest.mark.parametrize("impl", ["wave", "speculative", "device"])
def test_unported_impls_raise_naming_their_roadmap_item(impl):
    g = tcsr.from_edges(4, [0, 1], [1, 2])
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        tengine.build_distribution_labels(g, impl=impl)
    with pytest.raises(ValueError, match="unknown construction impl"):
        tengine.build_distribution_labels(g, impl="bogus")


def test_explicit_order_byte_identical():
    jdag = jgen.layered_dag(300, avg_out=2.0, seed=5)
    tdag = tcsr.CSRGraph(jdag.indptr.copy(), jdag.indices.copy())
    order = np.random.default_rng(3).permutation(jdag.n)
    _assert_same_labels(
        jengine.build_distribution_labels(jdag, order=order, impl="reference"),
        tengine.build_distribution_labels(tdag, order=order.copy()))
