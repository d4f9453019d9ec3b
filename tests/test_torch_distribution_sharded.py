"""The production cells' per-rank programs on 1, 2 and 4 gloo ranks on the
CPU (``tests/dist_ranks.py``, one process a rank, meeting through a
``FileStore`` under tmp_path): ``make_sharded_distribute_one`` over a
vertex-partitioned state, in both ``row_extract`` modes and over several
iterations, gives exactly one-process ``distribute_one``'s rows after every
iteration; ``make_row_sharded_serve_step`` gives ``serve_step``'s verdicts
on every rank; GCN's per-rank loss (``gcn.make_sharded_loss``) gives
``loss_fn``'s loss and gradients; xDeepFM's cell step
(``xdeepfm_cfg.make_train_step``) and the LM step over each rank's own rows
(``make_train_step(..., local_batch=True)``) give one process's step over
the whole batch.  On (4, 1) and, at 4 ranks, (2, 2).
"""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.distribution_device import distribute_one, init_state
from repro_torch.core.order import get_order
from repro_torch.graph.csr import from_edges
from repro_torch.graph.generators import layered_dag, random_dag
from repro_torch.models.gnn import gcn
from repro_torch.models.gnn.layers import GraphBatch
from repro_torch.serve.engine import serve_step
from repro_torch.tree import tree_leaves, tree_map

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
WORLDS = (1, 2, 4)
MAX_STEPS = 64
ITERATIONS = 12


def _start_world(tmp: pathlib.Path, world: int, job_path: pathlib.Path):
    """``world`` rank processes of ``dist_ranks.py`` on the job."""
    out = tmp / f"world{world}"
    out.mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(HERE), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "dist_ranks.py"), str(r), str(world), str(out / "store"),
         str(job_path), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    return out, procs


def _finish(procs, timeout) -> list:
    """Each process's output, killing every one past ``timeout``."""
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _case(g, l_max: int, rng) -> dict:
    """A graph padded to a multiple of 4 vertices (isolated) and 4 edges
    (self loops at vertex 0, which add nothing), the first ITERATIONS of its
    §5.2 order, the one-process states after each, and queries."""
    n = -(-g.n // 4) * 4
    fs, fd = g.edges()
    m = len(fs)
    pad = -(-m // 4) * 4 - m
    fs, fd = np.concatenate([fs, np.zeros(pad)]), np.concatenate([fd, np.zeros(pad)])
    edges = [np.asarray(x, np.int32) for x in (fs, fd, fd, fs)]
    order = get_order(g, "degree_product")[:ITERATIONS]
    te = [torch.from_numpy(e.astype(np.int64)) for e in edges]
    state, states = init_state(n, l_max, device="cpu"), []
    for vi in order:
        state = distribute_one(state, int(vi), *te, n, MAX_STEPS)
        states.append([t.numpy().copy() for t in state])
    return dict(n=n, l_max=l_max, max_steps=MAX_STEPS, edges=edges, order=order,
                states=states, L_out=states[-1][0], L_in=states[-1][1],
                queries=rng.integers(0, n, (64, 2)).astype(np.int32))


def _xdeepfm_job(rng) -> dict:
    from repro_torch.configs import xdeepfm_cfg
    from repro_torch.models.recsys import xdeepfm

    cfg = xdeepfm_cfg.smoke_config()
    params = xdeepfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return dict(params=tree_map(lambda t: t.numpy().copy(), params),
                batch=dict(ids=rng.integers(0, cfg.vocab_per_field, (16, cfg.n_fields))
                           .astype(np.int32),
                           y=(rng.random(16) < 0.5).astype(np.float32)))


def _lm_job(rng) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    cfg = get_arch("granite-3-2b").smoke_config()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
    return dict(params=tree_map(lambda t: t.numpy().copy(), params),
                batch=dict(tokens=tokens, labels=np.roll(tokens, -1, axis=1)))


def _gcn_job(rng) -> dict:
    n, m, d_in = 48, 160, 8
    return dict(x=rng.standard_normal((n, d_in)).astype(np.float32),
                src=rng.integers(0, n, m).astype(np.int32),
                dst=rng.integers(0, n, m).astype(np.int32),
                emask=rng.random(m) < 0.8, nmask=rng.random(n) < 0.7,
                y=rng.integers(0, 4, n).astype(np.int32),
                params=[(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
                        for s in ((d_in, 8), (8, 4))])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("oracle_ranks")
    rng = np.random.default_rng(0)
    cyc = from_edges(60, rng.integers(0, 60, 170), rng.integers(0, 60, 170))
    cases = [_case(random_dag(70, 200, seed=1), 16, rng),
             _case(layered_dag(80, avg_out=2.5, seed=2), 16, rng),
             _case(cyc, 8, rng)]
    job = {"oracle": {"cases": cases, "gcn": _gcn_job(rng), "xdeepfm": _xdeepfm_job(rng),
                      "lm": _lm_job(rng)}}
    job_path = tmp / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    started = [(w, *_start_world(tmp, w, job_path)) for w in WORLDS]
    out = {}
    for world, d, procs in started:
        logs = _finish(procs, 240)
        assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
        out[world] = [pickle.load(open(d / f"rank{r}.pkl", "rb"))["oracle"]
                      for r in range(world)]
    return job, out


def _shapes(world):
    return [(world, 1)] + ([(2, 2)] if world == 4 else [])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_distribute_one_equals_one_process(runs, world):
    """Each data rank's rows of L_out, L_in and the lengths, and overflow on
    every rank, equal one-process ``distribute_one``'s after every
    iteration, in both modes."""
    job, out = runs
    for shape in _shapes(world):
        P, M = shape
        for ci, case in enumerate(job["oracle"]["cases"]):
            nl = case["n"] // P
            for mode in ("gather", "onehot"):
                for rank in range(world):
                    d = rank // M
                    got = out[world][rank][(shape, ci, mode)]
                    assert len(got) == ITERATIONS
                    for it, (g, w) in enumerate(zip(got, case["states"])):
                        for name, a, b in zip(("L_out", "L_in", "out_len", "in_len"), g, w):
                            np.testing.assert_array_equal(
                                a, b[d * nl:(d + 1) * nl],
                                err_msg=f"{shape} case {ci} {mode} rank {rank} it {it} {name}")
                        assert bool(g[4]) == bool(w[4])


@pytest.mark.parametrize("world", WORLDS)
def test_row_sharded_serve_step_equals_serve_step(runs, world):
    """Every rank returns the whole batch's verdicts, ``serve_step``'s."""
    job, out = runs
    for shape in _shapes(world):
        for ci, case in enumerate(job["oracle"]["cases"]):
            want = serve_step(torch.from_numpy(case["L_out"]), torch.from_numpy(case["L_in"]),
                              torch.from_numpy(case["queries"])).numpy()
            assert want.any() and not want.all()
            for rank in range(world):
                np.testing.assert_array_equal(out[world][rank][(shape, ci, "serve")], want)


@pytest.mark.parametrize("world", WORLDS)
def test_gcn_sharded_loss_equals_loss_fn(runs, world):
    """GCN's loss over a graph split over the data ranks (JAX's layout:
    node blocks, edges split evenly) equals ``loss_fn`` on the whole graph
    (K5's plain version) with its gradients, within 1e-5, on every rank."""
    from repro_torch.configs import get_arch

    job, out = runs
    g = job["oracle"]["gcn"]
    cfg = get_arch("gcn-cora").smoke_config()
    params = [{"w": torch.from_numpy(w).requires_grad_(True)} for w in g["params"]]
    whole = GraphBatch(x=torch.from_numpy(g["x"]), edge_src=torch.from_numpy(g["src"]),
                       edge_dst=torch.from_numpy(g["dst"]), edge_mask=torch.from_numpy(g["emask"]),
                       node_mask=torch.from_numpy(g["nmask"]), y=torch.from_numpy(g["y"]))
    loss = gcn.loss_fn(cfg, params, whole)
    grads = torch.autograd.grad(loss, [p["w"] for p in params])
    for shape in _shapes(world):
        for rank in range(world):
            got_loss, got_grads = out[world][rank][(shape, "gcn")]
            assert got_loss == pytest.approx(float(loss), rel=1e-5, abs=1e-6)
            for a, b in zip(got_grads, grads):
                np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("world", WORLDS)
def test_xdeepfm_cell_step_equals_one_process(runs, world):
    """xDeepFM's cell step over each rank's rows of 16 (the gradients
    averaged onto each rank's ZeRO slice, the params all-gathered) gives
    one process's step over the whole batch: loss and params within 1e-6.
    On (world, 1): a model axis of more than one rank skips its cells."""
    from repro_torch.configs import xdeepfm_cfg
    from repro_torch.configs.cell import zero_pspecs
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.optim import zero_init
    from repro_torch.optim.adamw import zero_layout

    job, out = runs
    x = job["oracle"]["xdeepfm"]
    cfg = xdeepfm_cfg.smoke_config()
    params = _torch(x["params"])
    opt_p = zero_pspecs(params, xdeepfm.param_pspecs(cfg), None)
    state = zero_init(params, zero_layout(opt_p, None))
    params, _, metrics = xdeepfm_cfg.make_train_step(cfg, None, opt_p)(params, state,
                                                                       _torch(x["batch"]))
    for shape in [(world, 1)]:
        for rank in range(world):
            loss, got = out[world][rank][(shape, "xdeepfm")]
            assert loss == pytest.approx(float(metrics["loss"]), rel=1e-6)
            for a, b in zip(tree_leaves(got), tree_leaves(params)):
                np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_lm_step_on_local_rows_equals_one_process(runs, world):
    """``make_train_step(..., local_batch=True)``, each rank given only its
    rows, gives one process's step over the whole batch (granite's smoke
    config, n_accum 1 and 2): loss and params within 1e-5."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_cells import make_train_step, opt_layout
    from repro_torch.optim import zero_init

    job, out = runs
    lm = job["oracle"]["lm"]
    cfg = get_arch("granite-3-2b").smoke_config()
    for n_accum in (1, 2):
        params = _torch(lm["params"])
        state = zero_init(params, opt_layout(cfg, params, None))
        params, _, metrics = make_train_step(cfg, n_accum, None)(params, state,
                                                                 _torch(lm["batch"]))
        for shape in [(world, 1)]:
            for rank in range(world):
                loss, got = out[world][rank][(shape, "lm", n_accum)]
                assert loss == pytest.approx(float(metrics["loss"]), rel=1e-5)
                for a, b in zip(tree_leaves(got), tree_leaves(params)):
                    np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-5, atol=1e-6)
