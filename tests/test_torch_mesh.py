"""The port's multi-device modes against ``repro``'s, on the CPU.

The port runs a mesh as one process a rank (``torch.distributed`` over
gloo here); ``tests/mesh_ranks.py`` is one rank.  Each mesh shape is one
run of its ranks, meeting through a ``FileStore`` under ``tmp_path`` (never
a fixed port: tier-1 runs under xdist), every process and process group
with a timeout.  The JAX package runs in a subprocess on an 8-fake-device
(4, 2) mesh, as ``tests/test_serve_engine.py``'s sharded test runs it.
What is held, exactly, with no tolerance:

  * the ``sharded`` and ``sharded_hop`` backends at meshes (1, 1), (2, 2)
    and (4, 2), on the five families of ``_graph_families``, with the full
    labels and under ``truncate_store`` at 0.5 of the label bytes: every
    rank's verdicts, ``stats()["last_batch"]`` (prefiltered and tier counts)
    and degradation counters equal the JAX engine's, and BFS truth; an
    injected device failure, and a deadline that one rank alone is past,
    take every rank down the host rung, counted as JAX counts it;
  * a model axis that does not divide the label width (a (1, 3) mesh):
    JAX's jit refuses the sharding and its engine's catch-all serves the
    batch on the host; the port raises ``ValueError`` on every rank (only
    injected failures fall back, ROADMAP.md Queue 3);
  * the ``mesh=`` device build at data meshes of 1, 2 and 4 ranks: labels
    byte for byte equal to ``reference`` and to JAX's
    ``distribution_labeling_device(..., expand="xla", mesh=...)`` on a mesh
    of the same shape, on every rank, with one collective a level;
  * ``distribution_labeling_torch`` equals ``distribution_labeling_jax``;
  * the mesh helpers: shapes, axis groups, the two collectives.
"""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.distribution_jax import distribution_labeling_jax
from repro.graph.generators import layered_dag, random_dag, tree_dag
from repro.graph.scc import condense_to_dag
import repro_torch.graph.csr as tcsr
import repro_torch.serve.engine as tengine
from repro_torch.build.engine import build_distribution_labels
from repro_torch.core import distribution_labeling_torch
from repro_torch.launch import mesh as tmesh
from test_serve_engine import _graph_families, _truth_matrix

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
MESHES = [(1, 1), (2, 2), (4, 2)]
FAMILIES = [name for name, _ in _graph_families(np.random.default_rng(0))]
BUDGETS = [None, 0.5]
BACKENDS = ("sharded", "sharded_hop")
LABEL_FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")
# a run of ranks must end well inside tier-1's limit; a rank left waiting by
# one that failed raises after mesh_ranks.TIMEOUT (60 s)
RUN_TIMEOUT = 240

JAX_SNIPPET = """
import os, pickle, sys, time
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import jax, numpy as np
from jax.sharding import Mesh
from repro.build.engine_jax import distribution_labeling_device
from repro.core.api import build_oracle
from repro.ft import inject
from repro.graph.csr import CSRGraph
from repro.graph.scc import condense_to_dag
from repro.serve.budget import label_bytes, truncate_store
job = pickle.load(open(sys.argv[1], 'rb'))
mesh = jax.make_mesh((4, 2), ('data', 'model'))
res = {'serve': {}, 'inject': {}, 'deadline': {}, 'build': {}}
for name, indptr, indices, q in job['graphs']:
    g = CSRGraph(indptr, indices)
    co = build_oracle(g, mesh=mesh)
    for frac in (None, 0.5):
        co.engine.set_budget(None if frac is None else truncate_store(
            co.oracle, budget_bytes=int(label_bytes(co.oracle) * frac)))
        for be in ('sharded', 'sharded_hop'):
            co.engine.reset_stats()
            pred = co.serve(q, backend=be)
            st = co.engine.stats()
            res['serve'][(name, frac, be)] = (pred, st['last_batch'], st['degradation'])
    co.engine.set_budget(None)
    for be in ('sharded', 'sharded_hop'):
        co.engine.reset_stats()
        with inject.active(inject.Injector({'serve.device_dispatch': 0})):
            pred = co.serve(q, backend=be)
        st = co.engine.stats()
        res['inject'][(name, be)] = (pred, st['last_batch'], st['degradation'])
        co.engine.reset_stats()
        pred = co.serve(q, backend=be, deadline=time.monotonic() - 1.0)
        st = co.engine.stats()
        res['deadline'][(name, be)] = (pred, st['last_batch'], st['degradation'])
    dag, _ = condense_to_dag(g)
    # jax.make_mesh's Explicit axes make the build's scatter ambiguous on JAX
    # 0.9; a Mesh of the same devices (Auto axes) is what its own test uses
    for shape in job['build_meshes']:
        bmesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                     ('data', 'model'))
        o = distribution_labeling_device(dag, expand='xla', mesh=bmesh)
        res['build'][(name, shape)] = {f: getattr(o, f) for f in
                                       ('L_out', 'L_in', 'out_len', 'in_len', 'hop_rank')}
pickle.dump(res, open(sys.argv[2], 'wb'))
print('JAX_MESH_OK')
"""


def _queries(g, seed):
    """Uniform pairs (an odd count: the batch pads to the data shards), the
    diagonal and the corners, in original ids."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, g.n, size=(1001, 2)).astype(np.int32)
    diag = np.arange(g.n, dtype=np.int32)
    return np.concatenate([q, np.stack([diag, diag], 1),
                           np.array([[0, g.n - 1], [g.n - 1, 0]], np.int32)])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(HERE), env.get("PYTHONPATH", "")])
    return env


def _run_ranks(tmp: pathlib.Path, shape, job_path: pathlib.Path) -> list:
    """Start the ranks of one mesh, wait for all (killing every one past
    ``RUN_TIMEOUT``), and return each rank's results."""
    world = shape[0] * shape[1]
    out = tmp / f"mesh_{shape[0]}x{shape[1]}"
    out.mkdir()
    store = out / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "mesh_ranks.py"), str(r), str(world), str(store),
         f"{shape[0]},{shape[1]}", str(job_path), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env())
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RUN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, (failed, "\n".join(log[-3000:] for log in logs))
    return [pickle.load(open(out / f"rank{r}.pkl", "rb")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's results and each mesh's ranks' results, on one job:
    the five families with their queries (the JAX subprocess runs beside the
    port's ranks)."""
    tmp = tmp_path_factory.mktemp("mesh")
    fams = _graph_families(np.random.default_rng(0))
    graphs = [(name, g.indptr, g.indices, _queries(g, i)) for i, (name, g) in enumerate(fams)]
    job_path = tmp / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump({"graphs": graphs, "build": True, "build_meshes": MESHES}, f)
    jax_out = tmp / "jax.pkl"
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SNIPPET, str(job_path), str(jax_out)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env={**os.environ, "PYTHONPATH": str(SRC)})
    try:
        port = {shape: _run_ranks(tmp, shape, job_path) for shape in MESHES}
        # a model axis of 3 divides no DL label width (a multiple of 8)
        odd_job = tmp / "odd_job.pkl"
        with open(odd_job, "wb") as f:
            pickle.dump({"graphs": graphs[:1], "build": False}, f)
        port[(1, 3)] = _run_ranks(tmp, (1, 3), odd_job)
        log = jax_proc.communicate(timeout=RUN_TIMEOUT)[0]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert "JAX_MESH_OK" in log, log[-3000:]
    with open(jax_out, "rb") as f:
        jax_res = pickle.load(f)
    truth = {}
    for name, g in fams:
        q = graphs[[x[0] for x in graphs].index(name)][3]
        truth[name] = _truth_matrix(g.n, *g.edges())[q[:, 0], q[:, 1]]
    return {"jax": jax_res, "port": port, "truth": truth,
            "graphs": {name: g for name, g in fams}}


def _same(got, exp, what):
    pred, last, deg = got
    jpred, jlast, jdeg = exp
    assert np.array_equal(pred, jpred), what
    assert last == jlast, (what, last, jlast)
    assert deg == jdeg, (what, deg, jdeg)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("frac", BUDGETS, ids=["full", "budget0.5"])
@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_serving_matches_jax(runs, shape, name, frac, backend):
    key = (name, frac, backend)
    exp = runs["jax"]["serve"][key]
    assert np.array_equal(exp[0], runs["truth"][name])
    assert exp[1]["tiers"] == [] and not exp[2]["device_to_host"]
    for rank, res in enumerate(runs["port"][shape]):
        _same(res["serve"][key], exp, (shape, rank, key))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_injected_failure_takes_every_rank_down_the_same_rung(runs, shape, backend):
    for name in FAMILIES:
        exp = runs["jax"]["inject"][(name, backend)]
        assert exp[2]["device_to_host"] > 0
        for rank, res in enumerate(runs["port"][shape]):
            _same(res["inject"][(name, backend)], exp, (shape, rank, name, backend))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_one_rank_past_its_deadline_takes_every_rank_to_the_host(runs, shape, backend):
    """Rank 0 alone is past its deadline: the ranks agree before the first
    collective, and every rank serves the batch on the host merge, counted
    as JAX counts a batch past its deadline."""
    for name in FAMILIES:
        exp = runs["jax"]["deadline"][(name, backend)]
        assert exp[2]["deadline_to_host"] > 0
        assert np.array_equal(exp[0], runs["truth"][name])
        for rank, res in enumerate(runs["port"][shape]):
            _same(res["deadline"][(name, backend)], exp, (shape, rank, name, backend))


def test_model_axis_that_does_not_divide_the_width_raises_on_every_rank(runs):
    """JAX: ValueError from jit's in_shardings, served by the catch-all on
    the host (device_to_host).  The port raises it instead, on every rank,
    before any collective; ``sharded`` is unaffected."""
    name = FAMILIES[0]
    for rank, res in enumerate(runs["port"][(1, 3)]):
        for frac in BUDGETS:
            got = res["serve"][(name, frac, "sharded_hop")]
            assert got[0] == "ValueError" and "does not divide" in got[1], (rank, got)
            _same(res["serve"][(name, frac, "sharded")],
                  runs["jax"]["serve"][(name, frac, "sharded")], (rank, frac))


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}")
def test_mesh_build_is_the_reference_build(runs, shape, name):
    g = runs["graphs"][name]
    dag, _ = condense_to_dag(g)
    ref = build_distribution_labels(tcsr.CSRGraph(dag.indptr.copy(), dag.indices.copy()),
                                    impl="reference")
    jax_build = runs["jax"]["build"][(name, shape)]
    for rank, res in enumerate(runs["port"][shape]):
        labels, stats = res["build"][name]
        for f in LABEL_FIELDS:
            assert labels[f].tobytes() == getattr(ref, f).tobytes(), (shape, rank, name, f)
            assert labels[f].tobytes() == jax_build[f].tobytes(), (shape, rank, name, f)
        # one collective a level; every sweep runs a level at least
        assert stats["collectives"] == stats["levels"] >= stats["sweeps"] > 0
    # each level's slab calls fall on the data ranks that own rows
    calls = [res["build"][name][1]["slab_calls"] for res in runs["port"][shape]]
    assert sum(calls) >= runs["port"][shape][0]["build"][name][1]["levels"] > 0


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_build_counts_agree_across_ranks(runs, shape):
    """The level loop ends on every rank at once: every rank counts the same
    levels and collectives; the data ranks split the slab calls."""
    for name in FAMILIES:
        stats = [res["build"][name][1] for res in runs["port"][shape]]
        assert len({(s["levels"], s["collectives"], s["sweeps"]) for s in stats}) == 1, name
        coords = [tuple(res["coordinate"]) for res in runs["port"][shape]]
        assert sorted(coords) == [(d, m) for d in range(shape[0]) for m in range(shape[1])]


@pytest.mark.parametrize("seed", range(4))
def test_distribution_labeling_torch_matches_jax(seed):
    g = [random_dag(40, 90, seed=seed), layered_dag(45, avg_out=2.0, seed=seed),
         tree_dag(50, branching=3, seed=seed), random_dag(30, 120, seed=seed + 10)][seed]
    exp = distribution_labeling_jax(g, l_max=32)
    got = distribution_labeling_torch(tcsr.CSRGraph(g.indptr.copy(), g.indices.copy()),
                                      l_max=32, device="cpu")
    for f in ("L_out", "L_in", "out_len", "in_len"):
        assert getattr(got, f).tobytes() == getattr(exp, f).tobytes(), (seed, f)
    assert got.hop_rank is None and exp.hop_rank is None
    with pytest.raises(ValueError, match="label overflow"):
        distribution_labeling_torch(tcsr.CSRGraph(g.indptr.copy(), g.indices.copy()),
                                    l_max=1, device="cpu")


def test_distribution_labeling_torch_row_extract_modes():
    from repro_torch.core import distribution_device as dd

    jg = random_dag(30, 60, seed=2)
    g = tcsr.CSRGraph(jg.indptr.copy(), jg.indices.copy())
    args = [torch.from_numpy(x.astype(np.int64)) for x in (*g.edges(), *g.reverse().edges())]
    a = b = dd.init_state(g.n, 16, device="cpu")
    for vi in (5, 0, 17):
        a = dd.distribute_one(a, vi, *args, g.n, g.n, row_extract="gather")
        b = dd.distribute_one(b, vi, *args, g.n, g.n, row_extract="onehot")
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_distribution_state_defaults_to_the_card():
    """``init_state`` runs on the card unless asked for the CPU: without a
    card a bare call raises, as ``distribution_labeling_torch`` does."""
    from repro_torch.core import distribution_device as dd

    with pytest.raises(RuntimeError, match="no CUDA"):
        dd.init_state(4, 2)
    with pytest.raises(RuntimeError, match="no CUDA"):
        distribution_labeling_torch(tcsr.CSRGraph(np.zeros(2, np.int32), np.zeros(0, np.int32)))
    assert dd.init_state(4, 2, device="cpu").L_out.device.type == "cpu"


def test_select_backend_and_mesh_helpers():
    assert tengine.select_backend("auto", "cpu", mesh=object()) == "sharded"
    assert tengine.select_backend(None, "cuda") == "kernel"
    for be in BACKENDS:
        with pytest.raises(ValueError, match="requires a mesh"):
            tengine.select_backend(be, "cpu")
        assert tengine.select_backend(be, "cpu", mesh=object()) == be
    assert set(BACKENDS) <= set(tengine.BACKENDS)
    # no process group in this process: a mesh cannot be formed
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.form_mesh((1, 1), ("data", "model"))


def test_entry_points_take_a_mesh(tmp_path):
    """``build_oracle(mesh=)`` and ``oracle_from_snapshot(mesh=)`` hand the
    mesh to the engine, as ``repro.core.api`` does: over a one-rank mesh
    (JAX: one device) both serve ``sharded`` by default, with JAX's
    verdicts, prefilter counts and counters on both sharded backends."""
    import jax

    import repro.core.api as japi
    import repro.persist as jpersist
    import repro_torch.core.api as tapi
    from mesh_ranks import one_rank_mesh

    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    name, g = _graph_families(np.random.default_rng(0))[3]          # cyclic
    q = _queries(g, 7)
    jco = japi.build_oracle(g, mesh=jmesh)
    jpersist.save_oracle(str(tmp_path / "snap"), jco.oracle)
    tg = tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())
    with one_rank_mesh() as mesh:
        for tco in (tapi.build_oracle(tg, device="cpu", mesh=mesh),
                    tapi.oracle_from_snapshot(tg, str(tmp_path / "snap"), device="cpu",
                                              mesh=mesh)):
            assert tco.engine.backend == jco.engine.backend == "sharded"
            assert tco.engine.data_axes == jco.engine.data_axes == ("data",)
            for be in BACKENDS:
                jco.engine.reset_stats()
                tco.engine.reset_stats()
                assert (tco.serve(q, backend=be) == jco.serve(q, backend=be)).all(), be
                ts, js = tco.engine.stats(), jco.engine.stats()
                assert ts["last_batch"] == js["last_batch"], be
                assert ts["degradation"] == js["degradation"], be


def test_serve_steps_and_mesh_helpers_on_a_one_rank_mesh():
    """The step factories return JAX's triple, with DTensor placements as
    its descriptive items, and each step answers a batch as ``serve_step``
    does; the mesh helpers read the mesh's axes and run the two
    collectives."""
    from torch.distributed.tensor import Replicate, Shard

    from mesh_ranks import one_rank_mesh

    rng = np.random.default_rng(3)
    lo = torch.from_numpy(rng.integers(-1, 40, (50, 16)).astype(np.int32))
    li = torch.from_numpy(rng.integers(-1, 40, (50, 8)).astype(np.int32))
    q = torch.from_numpy(rng.integers(0, 50, (37, 2)).astype(np.int32))
    exp = tengine.serve_step(lo, li, q)
    with one_rank_mesh() as mesh:
        assert tmesh.data_axes_of(mesh) == ("data",) and tmesh.data_parallel_size(mesh) == 1
        assert tmesh.axes_except(mesh) == ("data",)
        fn, ins, out = tengine.make_sharded_serve_step(mesh, data_axes=("data",))
        assert ins == ((Replicate(), Replicate()), (Replicate(), Replicate()),
                       (Shard(0), Replicate())) and out == (Shard(0), Replicate())
        assert torch.equal(fn(lo, li, q), exp)
        fn, ins, out = tengine.make_hop_sharded_serve_step(mesh, data_axes=("data",))
        assert ins[0] == ins[1] == (Replicate(), Shard(1)) and out == (Shard(0), Replicate())
        assert torch.equal(fn(lo, li, q), exp)
        with pytest.raises(ValueError, match="not axes of the mesh"):
            tengine.make_sharded_serve_step(mesh)          # JAX's default ("pod", "data")
        g = tmesh.axis_group(mesh, ("data",))
        assert (g.size, g.index) == (1, 0)
        assert tmesh.axis_group(mesh, ("model",)).size == 1
        # the groups are the data axes' and the model axis'
        with pytest.raises(ValueError, match="groups for"):
            tmesh.axis_group(mesh, ("data", "model"))
        assert torch.equal(tmesh.or_over(torch.tensor([True, False]), g),
                           torch.tensor([True, False]))
        assert torch.equal(tmesh.gather_rows(torch.arange(6).view(3, 2), g),
                           torch.arange(6).view(3, 2))
        with pytest.raises(ValueError, match="or_over takes bool or uint8"):
            tmesh.or_over(torch.zeros(2, dtype=torch.int32), g)
    with pytest.raises(ValueError, match="not a mesh made by form_mesh"):
        tmesh.axis_group(object(), ("data",))
