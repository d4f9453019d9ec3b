"""The port's frontier-vector BFS (``repro_torch.graph.bfs``) against the JAX
package's (``repro.graph.bfs``) on the CPU, on the five graph families of
``tests/test_serve_engine.py`` (DAGs, cyclic, isolated vertices): every
function's result equal to JAX's, bit for bit, from single sources, from a
set of sources, with the step bounds cut short (1 and 3 steps) and
unbounded (n), and against a plain numpy BFS.
"""
import numpy as np
import pytest
import torch

from repro.graph import bfs as jbfs
from repro.graph.csr import CSRGraph as JCSRGraph
from repro_torch.graph import bfs
from repro_torch.graph.csr import CSRGraph
from test_serve_engine import _graph_families

FAMILIES = _graph_families(np.random.default_rng(0))
NAMES = [name for name, _ in FAMILIES]
STEPS = [1, 3, None]


def _graphs(name):
    g = dict(FAMILIES)[name]
    return CSRGraph(g.indptr, g.indices), JCSRGraph(g.indptr, g.indices)


def _sources(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.unique(np.concatenate([[0, n - 1], rng.integers(0, n, 5)])).astype(np.int32)


def _numpy_reach(g: CSRGraph, s: int, steps: int) -> np.ndarray:
    seen = np.zeros(g.n, bool)
    seen[s] = True
    frontier = [s]
    for _ in range(steps):
        nxt = [w for v in frontier for w in g.out_neighbors(v) if not seen[w]]
        if not nxt:
            break
        seen[nxt] = True
        frontier = list(set(nxt))
    return seen


@pytest.mark.parametrize("name", NAMES)
def test_csr_device_arrays(name):
    tg, jg = _graphs(name)
    src, dst = bfs.csr_device_arrays(tg, device="cpu")
    jsrc, jdst = jbfs.csr_device_arrays(jg)
    assert src.dtype == dst.dtype == torch.int32
    assert np.array_equal(src.numpy(), np.asarray(jsrc))
    assert np.array_equal(dst.numpy(), np.asarray(jdst))


@pytest.mark.parametrize("steps", STEPS, ids=["1", "3", "n"])
@pytest.mark.parametrize("name", NAMES)
def test_single_and_set_sources(name, steps):
    """bfs_step, bfs_reach, k_hop_neighborhood and bfs_levels_device from each
    source, and bfs_reach from the whole source set, = JAX's."""
    tg, jg = _graphs(name)
    n = tg.n
    k = n if steps is None else steps
    src, dst = bfs.csr_device_arrays(tg, device="cpu")
    jsrc, jdst = jbfs.csr_device_arrays(jg)
    sources = _sources(n, k)
    for s in sources:
        init = np.zeros(n, bool)
        init[s] = True
        t_init = torch.from_numpy(init)
        got = bfs.bfs_step(t_init, src, dst, n).numpy()
        assert np.array_equal(got, np.asarray(jbfs.bfs_step(init, jsrc, jdst, n))), s
        got = bfs.bfs_reach(t_init, src, dst, n, k).numpy()
        assert np.array_equal(got, np.asarray(jbfs.bfs_reach(init, jsrc, jdst, n, k))), s
        assert np.array_equal(got, _numpy_reach(tg, int(s), k)), s
        if steps is not None:   # k_hop is unrolled k times in JAX: keep k small
            got = bfs.k_hop_neighborhood(t_init, src, dst, n, k).numpy()
            want = jbfs.k_hop_neighborhood(init, jsrc, jdst, n, k)
            assert np.array_equal(got, np.asarray(want)), s
        got = bfs.bfs_levels_device(int(s), src, dst, n, k)
        assert got.dtype == torch.int32
        want = jbfs.bfs_levels_device(np.int32(s), jsrc, jdst, n, k)
        assert np.array_equal(got.numpy(), np.asarray(want)), s
    init = np.zeros(n, bool)
    init[sources] = True
    got = bfs.bfs_reach(torch.from_numpy(init), src, dst, n, k).numpy()
    assert np.array_equal(got, np.asarray(jbfs.bfs_reach(init, jsrc, jdst, n, k)))


@pytest.mark.parametrize("steps", STEPS, ids=["1", "3", "n"])
@pytest.mark.parametrize("name", NAMES)
def test_multi_source_reach(name, steps):
    tg, jg = _graphs(name)
    sources = _sources(tg.n, 7)
    got = bfs.multi_source_reach(sources, tg, max_steps=steps, device="cpu")
    want = jbfs.multi_source_reach(sources, jg, max_steps=steps)
    assert got.shape == (sources.shape[0], tg.n) and got.dtype == bool
    assert np.array_equal(got, np.asarray(want))
    k = tg.n if steps is None else steps
    for i, s in enumerate(sources):
        assert np.array_equal(got[i], _numpy_reach(tg, int(s), k)), s


def test_runs_on_the_card_unless_told():
    """csr_device_arrays and multi_source_reach default to the card: on a box
    without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    tg, _ = _graphs(NAMES[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bfs.csr_device_arrays(tg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bfs.multi_source_reach(np.array([0]), tg)
