"""The port's §6 baselines against ``repro``'s, on the CPU.

On the condensations of the five serve-test families (and two wider random
DAGs), each baseline of the port (``OnlineBFS``, GRAIL, interval TC
compression, the PWAH-style bit vectors, K-Reach and Cohen's 2-HOP set
cover) gives the JAX package's answer on every ordered pair, the same
``index_size_ints`` and the same index arrays, and every answer equals BFS
truth.
"""
import numpy as np
import pytest

import repro.core.baselines as jb
from repro.graph.generators import random_dag
from repro.graph.scc import condense_to_dag
import repro_torch.core.baselines as tb
import repro_torch.graph.csr as tcsr
from test_serve_engine import _graph_families, _truth_matrix

GRAPHS = [(name, condense_to_dag(g)[0]) for name, g in _graph_families(np.random.default_rng(0))]
GRAPHS += [("random_120", random_dag(120, 360, seed=11)), ("random_150", random_dag(150, 600, seed=12))]
NAMES = ["OnlineBFS", "Grail", "IntervalTC", "PWAHBitvector", "KReach", "TwoHopSetCover"]


def _index_arrays(idx) -> list:
    """The arrays each baseline's answers come from."""
    name = type(idx).__name__
    if name == "Grail":
        return [idx.lo, idx.hi]
    if name == "IntervalTC":
        return [idx.post, *idx.intervals]
    if name == "PWAHBitvector":
        return [idx.rank, *idx.word_idx, *idx.word_val]
    if name == "KReach":
        return [idx.in_cover, idx.cover, idx.cover_id, idx.tc_cover]
    if name == "TwoHopSetCover":
        o = idx.oracle
        return [o.L_out, o.L_in, o.out_len, o.in_len]
    return []


@pytest.mark.parametrize("cls", NAMES)
@pytest.mark.parametrize("gi", range(len(GRAPHS)), ids=[n for n, _ in GRAPHS])
def test_baseline_matches_jax(gi, cls):
    name, g = GRAPHS[gi]
    exp = getattr(jb, cls)(g)
    got = getattr(tb, cls)(tcsr.CSRGraph(g.indptr.copy(), g.indices.copy()))
    assert got.name == exp.name
    assert got.index_size_ints == exp.index_size_ints, (name, cls)
    for a, b in zip(_index_arrays(got), _index_arrays(exp), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), \
            (name, cls)
    truth = _truth_matrix(g.n, *g.edges())
    ans_got = np.array([[got.query(u, v) for v in range(g.n)] for u in range(g.n)])
    ans_exp = np.array([[exp.query(u, v) for v in range(g.n)] for u in range(g.n)])
    assert np.array_equal(ans_got, ans_exp), (name, cls)
    assert np.array_equal(ans_got, truth), (name, cls)


@pytest.mark.parametrize("cls", ["Grail", "TwoHopSetCover"])
def test_baseline_options_match_jax(cls):
    """GRAIL's traversal count and seed, 2-HOP's round cap."""
    g = GRAPHS[-1][1]
    tg = tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())
    kws = [{"k": 2, "seed": 3}, {"k": 7, "seed": 1}] if cls == "Grail" else \
        [{"max_rounds": 5}, {"max_rounds": 40}]
    for kw in kws:
        exp, got = getattr(jb, cls)(g, **kw), getattr(tb, cls)(tg, **kw)
        assert got.index_size_ints == exp.index_size_ints, kw
        for a, b in zip(_index_arrays(got), _index_arrays(exp), strict=True):
            assert a.tobytes() == b.tobytes(), kw
        for u in range(0, g.n, 3):
            for v in range(0, g.n, 5):
                assert got.query(u, v) == exp.query(u, v), (kw, u, v)
