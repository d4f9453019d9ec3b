"""The port's training across ranks against ``repro``'s, on the CPU.

The port runs one process a rank (``torch.distributed`` over gloo);
``tests/dist_ranks.py`` is one rank.  Worlds of 1, 2 and 4 ranks each meet
through a ``FileStore`` under the test's temporary directory (never a fixed
port: tier-1 runs under xdist), every process and process group with a
timeout.  The JAX package runs in a subprocess on 4 fake CPU devices, its
meshes ``Mesh(np.array(jax.devices()[:k]).reshape(shape), names)`` (Auto
axes: ``jax.make_mesh``'s Explicit axes break its ``shard_map`` code on JAX
0.9, ROADMAP.md Queue 3).  Held:

  * ``partition_edges_by_dst`` byte for byte on the five families of
    ``tests/test_serve_engine.py``, at 1, 2 and 4 shards;
  * the int8 codes and scales equal to JAX's, dequantized within 1 float32
    ulp; ``quantized_psum_grads`` over 1, 2 and 4 ranks equal to JAX's
    ``shard_map`` result within 1e-6 relative and to a numpy model of the
    formula; the stochastic variant unbiased over many draws, its codes
    within 1 of the rounded ones, its sum the same on every rank;
  * ``make_train_step`` on meshes (1, 1), (2, 1) and (4, 1) against JAX's,
    with JAX's params (``params_from_jax``): two steps' losses, the params
    and the gathered master and moments within 1e-5, for smoke granite at
    ``n_accum`` 1 and 2, a batch whose ``-1`` labels differ by rank, and
    the smoke granite-moe (aux != 0); the params byte-equal on every rank;
    the ZeRO state round trip through a checkpoint (a model axis of more
    than one rank: ``tests/test_torch_tensor_parallel.py``);
  * ``zero_pspecs`` (and the step's ZeRO layout) equal to JAX's choice on
    the same mesh shapes, for the LM configs' full shapes, and the other
    mesh helpers of ``configs.cell`` equal to JAX's;
  * ``make_dstlocal_loss`` on 1, 2 and 4 ranks and on a (pod, data) mesh:
    loss and gradients against JAX's, and against the single-process
    ``loss_fn`` at JAX's own bounds; a ``make_gnn_train_step`` step on it,
    and that step against JAX's ``gnn_train_cell`` step in one process;
  * SchNet's, GatedGCN's and GraphCast's ``make_sharded_loss`` (each rank
    its node block and its edge block, JAX's layout) on (1, 1), (2, 1),
    (4, 1) and a (pod, data) mesh: the loss within 1e-5 relative and each
    gradient leaf within 1e-4 of its largest magnitude of JAX's
    ``loss_fn`` and ``jax.grad`` over the whole graph, with JAX's params;
    one ``make_gnn_train_step`` step equal on every rank and to JAX's
    ``gnn_train_cell`` step; and the control, the same losses with a
    gather whose adjoint keeps each rank's own gradient rows unsummed,
    rejected by the gradients' bound on 2 and 4 ranks;
  * ``pipeline_apply`` over 1, 2 and 4 stages against the sequential run,
    in JAX and in torch, output and gradients.
"""
import os
import pathlib
import pickle
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_arch as jax_arch
from repro.configs.cell import zero_pspecs as jax_zero_pspecs
from repro.configs.gnn_cells import gnn_train_cell
from repro.graph.generators import random_dag
from repro.graph.partition import partition_edges_by_dst as jax_partition
from repro.models import transformer as jtf
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import graphcast as jgraphcast
from repro.models.gnn import schnet as jschnet
from repro.models.gnn.layers import GraphBatch as JGraphBatch
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import compression as jcomp
from repro_torch.configs.gnn_cells import make_gnn_train_step
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.partition import partition_edges_by_dst
from repro_torch.models.gnn import gatedgcn
from repro_torch.models.gnn.layers import GraphBatch
from repro_torch.optim import adamw_init
from repro_torch.optim import compression as tcomp
from repro_torch.tree import tree_leaves
from test_serve_engine import _graph_families

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
WORLDS = [1, 2, 4]
FAMILIES = _graph_families(np.random.default_rng(0))
# a run of ranks must end well inside tier-1's limit; a rank left waiting by
# one that failed raises after dist_ranks.TIMEOUT (60 s)
RUN_TIMEOUT = 240
TRAIN_CASES = {"granite_a1": ("granite-3-2b", 1), "granite_a2": ("granite-3-2b", 2),
               "masked": ("granite-3-2b", 2), "moe": ("granite-moe-1b-a400m", 2)}
# JAX's step gives the same numbers on every mesh shape; it runs every case
# on (4, 1) and the main case on each shape
JAX_TRAIN_WORLDS = {"granite_a2": WORLDS}
TRAIN_TOL = 1e-5
COMPRESS_RTOL = 1e-6
ZERO_ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "h2o-danube-1.8b", "deepseek-7b",
              "deepseek-v2-lite-16b"]
ZERO_MESHES = {1: [((1, 1), ("data", "model"))],
               2: [((2, 1), ("data", "model")), ((1, 2), ("data", "model"))],
               4: [((4, 1), ("data", "model")), ((2, 2), ("data", "model")),
                   ((2, 2, 1), ("pod", "data", "model"))]}
DSTLOCAL_CFG = dict(n_layers=3, d_in=8, d_edge_in=4, d_hidden=16, n_classes=4)
DSTLOCAL_MESHES = {"d1": ((1,), ("data",)), "d2": ((2,), ("data",)), "d4": ((4,), ("data",)),
                   "pd22": ((2, 2), ("pod", "data"))}
# JAX's own bounds for the dst-local loss against loss_fn (the node stream
# crosses ranks in bfloat16): tests/test_dist.py's
DSTLOCAL_LOSS_TOL, DSTLOCAL_GRAD_TOL = 5e-3, 2e-2
# the port's dst-local loss against JAX's: the same bfloat16 rounding of
# float32 streams that differ in their last bits; the gradients within one
# bfloat16 step (2^-8) of each leaf's largest, since JAX rounds the node
# stream's gradient to bfloat16 before its reduce-scatter and the port sums
# it in float32 (measured: 1.2e-3 of the largest at most)
DSTLOCAL_VS_JAX_TOL = 1e-4
DSTLOCAL_VS_JAX_GRAD_REL = 2.0 ** -8
PIPELINE_TOL = 1e-5
# the per-rank losses of SchNet, GatedGCN and GraphCast in JAX's layout
GNN_SHARDED_MESHES = {"w1": ((1, 1), ("data", "model")), "w2": ((2, 1), ("data", "model")),
                      "w4": ((4, 1), ("data", "model")), "pd22": ((2, 2), ("pod", "data"))}
GNN_SHARDED = {"schnet": jschnet, "gatedgcn": jgatedgcn, "graphcast": jgraphcast}
GNN_SHARDED_N, GNN_SHARDED_M, GNN_SHARDED_N_MESH = 48, 160, 16
GNN_SHARDED_LOSS_REL, GNN_SHARDED_GRAD_REL = 1e-5, 1e-4
# the step's params against JAX's: float32 sums in other orders, through
# one AdamW step (test_gnn_train_step_matches_jax's bounds)
GNN_SHARDED_STEP_RTOL, GNN_SHARDED_STEP_ATOL = 1e-5, 1e-6

JAX_SNIPPET = """
import os, pickle, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_arch
from repro.configs.lm_cells import make_train_step
from repro.models.gnn import gatedgcn
from repro.models.gnn.layers import GraphBatch
from repro.optim import adamw_init
from repro.optim.compression import quantized_psum_grads
job = pickle.load(open(sys.argv[1], 'rb'))
def mesh_of(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
res = {'compress': {}, 'train': {}, 'dstlocal': {}}
for W in job['worlds']:
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *job['compress'][:W])
    fn = shard_map(lambda g: quantized_psum_grads(jax.tree.map(lambda a: a[0], g), 'data'),
                   mesh=mesh_of((W,), ('data',)), in_specs=P('data'), out_specs=P(),
                   check_rep=False)
    res['compress'][W] = jax.tree.map(np.asarray, jax.jit(fn)(stacked))
for name, case in job['train'].items():
    cfg = get_arch(case['arch']).smoke_config()
    params = jax.tree.map(jnp.asarray, case['params'])
    batch = {k: jnp.asarray(v) for k, v in case['batch'].items()}
    for W in case['jax_worlds']:
        step = jax.jit(make_train_step(cfg, case['n_accum'], mesh_of((W, 1), ('data', 'model'))))
        p, st, losses = params, adamw_init(params), []
        for _ in range(2):
            p, st, m = step(p, st, batch)
            losses.append(float(m['loss']))
        res['train'][(name, W)] = {'loss': losses, 'grad_norm': float(m['grad_norm']),
                                   'params': jax.tree.map(np.asarray, p),
                                   'state': jax.tree.map(np.asarray, (st.mu, st.nu, st.master))}
dl = job['dstlocal']
cfg = gatedgcn.GatedGCNConfig(**dl['cfg'])
params = jax.tree.map(jnp.asarray, dl['params'])
for key, (shape, names) in dl['meshes'].items():
    b = dl['batches'][int(np.prod(shape))]
    g = GraphBatch(**{k: (jnp.asarray(v) if v is not None else None) for k, v in b.items()})
    loss = gatedgcn.make_dstlocal_loss(cfg, mesh_of(shape, names), names)
    l, gr = jax.jit(jax.value_and_grad(lambda p: loss(p, g)))(params)
    res['dstlocal'][key] = (float(l), [np.asarray(x) for x in jax.tree.leaves(gr)])
pickle.dump(res, open(sys.argv[2], 'wb'))
print('JAX_DIST_OK')
"""


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pad(n: int, k: int) -> int:
    return -(-n // k) * k


def _train_job(rng) -> dict:
    cases = {}
    for name, (arch, n_accum) in TRAIN_CASES.items():
        cfg = jax_arch(arch).smoke_config()
        # 8 rows of 32: two microbatches of 4, one row a rank at 4 ranks;
        # 32 tokens a row is the MoE's dispatch group
        tok = rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
        lab = rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
        if name == "masked":   # each rank's rows hold another count of labels
            lab[0, :30] = -1
            lab[5] = -1
            lab[6, 3:] = -1
        cases[name] = {"arch": arch, "n_accum": n_accum,
                       "jax_worlds": JAX_TRAIN_WORLDS.get(name, [4]),
                       "params": _np(jtf.init_params(cfg, jax.random.PRNGKey(0))),
                       "batch": {"tokens": tok, "labels": lab}}
    return cases


def _dstlocal_job(rng) -> dict:
    cfg = jgatedgcn.GatedGCNConfig(**DSTLOCAL_CFG)
    n = 64
    g = random_dag(n, 200, seed=1)
    x = rng.standard_normal((n, cfg.d_in)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    node_mask = rng.random(n) < 0.9   # masked nodes leave each rank another count
    batches = {}
    for w in WORLDS:
        src, dst, mask, _ = jax_partition(g, w, n_pad=n)
        m = src.shape[0]
        batches[w] = dict(x=x, edge_src=src, edge_dst=dst, edge_mask=mask, node_mask=node_mask,
                          edge_attr=rng.standard_normal((m, cfg.d_edge_in)).astype(np.float32),
                          pos=None, y=y)
    return {"cfg": DSTLOCAL_CFG, "meshes": DSTLOCAL_MESHES, "batches": batches,
            "params": _np(jgatedgcn.init_params(cfg, jax.random.PRNGKey(0)))}


def _with_biases(tree, rng):
    """JAX's params with every MLP bias ("b", zeros at init) drawn instead."""
    if isinstance(tree, dict):
        return {k: (np.asarray(rng.standard_normal(v.shape) * 0.1, np.float32) if k == "b"
                    else _with_biases(v, rng)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_biases(v, rng) for v in tree]
    return np.asarray(tree)


def _gnn_sharded_job(rng) -> dict:
    """Each model's smoke config, JAX's params (the MLP biases drawn) and a
    whole graph made with numpy: 48 nodes and 160 edges (masked nodes and
    edges); GraphCast 48 grid rows, 16 mesh nodes and 96 / 64 / 96 edges."""
    n, m = GNN_SHARDED_N, GNN_SHARDED_M
    models = {}
    for name, jmod in GNN_SHARDED.items():
        cfg = jax_arch(name).smoke_config()
        params = _with_biases(jmod.init_params(cfg, jax.random.PRNGKey(3)), rng)
        if name == "graphcast":
            nm = GNN_SHARDED_N_MESH
            batch = dict(
                grid_x=rng.standard_normal((n, cfg.n_vars)).astype(np.float32),
                g2m_src=rng.integers(0, n, 96).astype(np.int32),
                g2m_dst=rng.integers(0, nm, 96).astype(np.int32),
                mesh_src=rng.integers(0, nm, 64).astype(np.int32),
                mesh_dst=rng.integers(0, nm, 64).astype(np.int32),
                m2g_src=rng.integers(0, nm, 96).astype(np.int32),
                m2g_dst=rng.integers(0, n, 96).astype(np.int32),
                target=rng.standard_normal((n, cfg.n_vars)).astype(np.float32))
            models[name] = {"arch": name, "params": params, "batch": batch, "n_mesh": nm}
            continue
        batch = dict(edge_src=rng.integers(0, n, m).astype(np.int32),
                     edge_dst=rng.integers(0, n, m).astype(np.int32),
                     edge_mask=rng.random(m) < 0.85, node_mask=rng.random(n) < 0.9,
                     edge_attr=None, pos=None)
        if name == "schnet":   # atom types 0-4 in column 0, positions within the cutoff
            batch.update(x=rng.integers(0, 5, (n, 1)).astype(np.float32),
                         pos=(rng.standard_normal((n, 3)) * 1.5).astype(np.float32),
                         y=np.linspace(-1, 1, n, dtype=np.float32))
        else:
            batch.update(x=rng.standard_normal((n, cfg.d_in)).astype(np.float32),
                         edge_attr=rng.standard_normal((m, cfg.d_edge_in)).astype(np.float32),
                         y=rng.integers(0, cfg.n_classes, n).astype(np.int32))
        models[name] = {"arch": name, "params": params, "batch": batch}
    return {"meshes": GNN_SHARDED_MESHES, "models": models}


def _pipeline_job(rng) -> dict:
    return {w: {"w": (rng.standard_normal((w, 2, 16, 16)) * 0.3).astype(np.float32),
                "x": rng.standard_normal((8, 4, 16)).astype(np.float32),
                "proj": rng.standard_normal((8, 4, 16)).astype(np.float32)} for w in WORLDS}


def _zero_shapes() -> dict:
    out = {}
    for arch in ZERO_ARCHS:
        cfg = jax_arch(arch).full_config()
        specs = jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.PRNGKey(0)))
        out[arch] = jax.tree.map(lambda s: tuple(s.shape), specs)
    return out


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(HERE), env.get("PYTHONPATH", "")])
    return env


def _start_world(tmp: pathlib.Path, world: int, job_path: pathlib.Path):
    out = tmp / f"world{world}"
    out.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "dist_ranks.py"), str(r), str(world), str(out / "store"),
         str(job_path), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env())
        for r in range(world)]
    return out, procs


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _finish(procs, timeout) -> list:
    """Each process's output, killing every one past ``timeout``."""
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        _kill(procs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's results and each world's ranks' results on one job
    (the JAX subprocess runs beside the port's ranks)."""
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    job = {"worlds": WORLDS, "train": _train_job(rng), "ckpt_case": "granite_a2",
           "compress": [{"a": rng.standard_normal((300,)).astype(np.float32),
                         "b": [(rng.standard_normal((7, 50)) * 10.0 ** -k).astype(np.float32)
                               for k in range(3)]} for _ in range(4)],
           "dstlocal": _dstlocal_job(rng), "gnn_sharded": _gnn_sharded_job(rng),
           "pipeline": _pipeline_job(rng),
           "zero_shapes": _zero_shapes(), "zero_meshes": ZERO_MESHES}
    job_path = tmp / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    jax_out = tmp / "jax.pkl"
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SNIPPET, str(job_path), str(jax_out)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env={**os.environ, "PYTHONPATH": str(SRC)})
    worlds = {w: _start_world(tmp, w, job_path) for w in WORLDS}
    port = {}
    try:
        for w, (out, procs) in worlds.items():
            logs = _finish(procs, RUN_TIMEOUT)
            failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
            assert not failed, (w, failed, "\n".join(log[-3000:] for log in logs))
            port[w] = [pickle.load(open(out / f"rank{r}.pkl", "rb")) for r in range(w)]
        log = _finish([jax_proc], RUN_TIMEOUT)[0]
    finally:
        for _, procs in worlds.values():
            _kill(procs)
        _kill([jax_proc])
    assert "JAX_DIST_OK" in log, log[-3000:]
    with open(jax_out, "rb") as f:
        jax_res = pickle.load(f)
    return {"job": job, "jax": jax_res, "port": port}


# ------------------------------------------------------------------ partition


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("name", [name for name, _ in FAMILIES])
def test_partition_byte_equal(name, shards):
    g = dict(FAMILIES)[name]
    for n_pad in (_pad(g.n, shards), _pad(g.n, shards) + 4 * shards):
        want = jax_partition(g, shards, n_pad=n_pad)
        got = partition_edges_by_dst(CSRGraph(g.indptr, g.indices), shards, n_pad=n_pad)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (name, shards, n_pad)


# ------------------------------------------------------------------ compression


def _quantize_inputs():
    rng = np.random.default_rng(3)
    ties = (np.arange(-300, 300, dtype=np.float32) + 0.5) / 2.0   # x.25, x.75 and halves
    x = rng.standard_normal((3, 400)).astype(np.float32) * 5
    x[1] = 0.0                                                     # an all-zero block
    return [("ties", ties), ("normal", x), ("tiny", rng.standard_normal(7).astype(np.float32)
                                             * 1e-30), ("wide", np.float32([1e30, -1e-30, 3.0]))]


@pytest.mark.parametrize("block", [256, 64])
@pytest.mark.parametrize("case", range(4), ids=[c[0] for c in _quantize_inputs()])
def test_quantize_codes_equal_jax(case, block):
    _, x = _quantize_inputs()[case]
    q, s = tcomp._quantize_int8(torch.from_numpy(x), block=block)
    jq, js = jcomp._quantize_int8(jnp.asarray(x), None, block)
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    d = tcomp._dequantize_int8(q, s, x.shape).numpy()
    jd = np.asarray(jcomp._dequantize_int8(jq, js, x.shape, block))
    ulp = np.spacing(np.abs(jd).astype(np.float32))
    assert d.shape == x.shape and np.all(np.abs(d - jd) <= ulp)


def test_stochastic_rounding_unbiased():
    """Over 4,000 draws the dequantized values average to the input within
    4 standard errors of a uniform rounding; each code within 1 of the
    rounded one."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    q0, s = tcomp._quantize_int8(x)
    gen = torch.Generator().manual_seed(0)
    draws = 4000
    acc = torch.zeros(512, dtype=torch.float64)
    for _ in range(draws):
        q, s2 = tcomp._quantize_int8(x, gen)
        assert torch.equal(s2, s)
        assert int((q.int() - q0.int()).abs().max()) <= 1
        acc += tcomp._dequantize_int8(q, s, x.shape).double()
    err = (acc / draws - x.double()).abs()
    bound = 4 * 0.5 * s.double().repeat_interleave(256)[:512] / np.sqrt(draws)
    assert bool((err <= bound).all()), float((err / bound).max())


def _numpy_psum(grads: list, block: int = 256) -> tuple:
    """JAX's formula in numpy: each rank's codes and scales, the int32 sum,
    the mean scale, the division by the ranks.  Also each element's mean
    scale."""
    n = len(grads)
    out, scales = [], []
    for leaves in zip(*[jax.tree.leaves(g) for g in grads]):
        qs, ss = [], []
        for a in leaves:
            flat = np.pad(a.reshape(-1), (0, (-a.size) % block)).reshape(-1, block)
            s = np.abs(flat).max(1, keepdims=True) / np.float32(127.0)
            s = np.where(s == 0, np.float32(1.0), s).astype(np.float32)
            qs.append(np.clip(np.round(flat / s), -127, 127).astype(np.int32))
            ss.append(s)
        mean = sum(ss) / np.float32(n)
        deq = sum(qs).astype(np.float32) * mean
        shape, size = leaves[0].shape, leaves[0].size
        out.append(deq.reshape(-1)[:size].reshape(shape) / np.float32(n))
        scales.append(np.broadcast_to(mean, deq.shape).reshape(-1)[:size].reshape(shape))
    return out, scales


@pytest.mark.parametrize("world", WORLDS)
def test_quantized_psum_grads(runs, world):
    grads = runs["job"]["compress"][:world]
    want = [np.asarray(x) for x in jax.tree.leaves(runs["jax"]["compress"][world])]
    model, scales = _numpy_psum(grads)
    first = jax.tree.leaves(runs["port"][world][0]["compress_sto"])
    for r, res in enumerate(runs["port"][world]):
        got = jax.tree.leaves(res["compress"])
        for g, w, m in zip(got, want, model):
            np.testing.assert_allclose(g, w, rtol=COMPRESS_RTOL, atol=0)
            np.testing.assert_allclose(g, m, rtol=COMPRESS_RTOL, atol=0)
        # stochastic: the same sum on every rank, each rank's codes at most
        # one step from the rounded ones, so the mean within one mean scale
        for s, f, g, sc in zip(jax.tree.leaves(res["compress_sto"]), first, got, scales):
            assert np.array_equal(s, f), r
            assert np.all(np.abs(s - g) <= sc * (1 + 1e-5))


# ------------------------------------------------------------------ the LM step


def _close(got, want, what, tol=TRAIN_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(float(np.abs(want).max()),
                                                                    1e-30), err_msg=what)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_matches_jax(runs, case, world):
    jw = world if world in runs["job"]["train"][case]["jax_worlds"] else 4
    want = runs["jax"]["train"][(case, jw)]
    ranks = runs["port"][world]
    for r, res in enumerate(ranks):
        got = res["train"][case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TRAIN_TOL, atol=0)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
        for i, (a, b) in enumerate(zip(jax.tree.leaves(got["params"]),
                                       jax.tree.leaves(want["params"]))):
            _close(a, b, f"{case} rank {r} param {i}")
            # every rank holds the same bytes
            assert a.tobytes() == jax.tree.leaves(ranks[0]["train"][case]["params"])[i].tobytes()
        for part, g, w in zip(("mu", "nu", "master"), got["state"], want["state"]):
            for i, (a, b) in enumerate(zip(jax.tree.leaves(g), jax.tree.leaves(w))):
                _close(a, b, f"{case} rank {r} {part} {i}")


def test_moe_aux_is_in_the_loss():
    """The MoE case's loss carries a non-zero aux (so the step's aux over
    the whole microbatch is exercised)."""
    cfg = jax_arch("granite-moe-1b-a400m").smoke_config()
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tok = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)), jnp.int32)
    _, aux = jtf.forward(cfg, params, tok)
    assert float(aux) > 0.1


@pytest.mark.parametrize("world", WORLDS)
def test_zero_layout_matches_jax(runs, world):
    """The step's ZeRO dimension of every leaf is the one JAX's
    ``zero_pspecs`` gives that leaf on the same mesh shape, and each rank's
    state is its slice."""
    class StubMesh:   # all that JAX's zero_pspecs reads of a mesh
        axis_names = ("data", "model")
        shape = {"data": world, "model": 1}

    for case, (arch, _) in TRAIN_CASES.items():
        cfg = jax_arch(arch).smoke_config()
        params = jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.PRNGKey(0)))
        specs = jax.tree.leaves(jax_zero_pspecs(params, jtf.param_pspecs(cfg), StubMesh),
                                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = tuple(next((i for i, e in enumerate(s) if e == "data"), None) for s in specs)
        shapes = [p.shape for p in jax.tree.leaves(params)]
        for r, res in enumerate(runs["port"][world]):
            assert res["train"][case]["dims"] == want, (case, r)
            for d, shape, part in zip(want, shapes, res["train"][case]["slice_shapes"]):
                full = list(shape)
                if d is not None:
                    full[d] //= world
                assert tuple(full) == part


@pytest.mark.parametrize("world", WORLDS)
def test_zero_pspecs_match_jax(runs, world):
    shapes = runs["job"]["zero_shapes"]
    for shape, names in ZERO_MESHES[world]:
        class StubMesh:
            axis_names = names
        StubMesh.shape = dict(zip(names, shape))
        for arch in ZERO_ARCHS:
            cfg = jax_arch(arch).full_config()
            sds = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes[arch],
                               is_leaf=lambda x: isinstance(x, tuple))
            want = jax_zero_pspecs(sds, jtf.param_pspecs(cfg), StubMesh)
            want = jax.tree.map(tuple, want,
                                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            for res in runs["port"][world]:
                assert res["zero"][(arch, shape, names)] == want, (arch, shape, names)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_helpers_match_jax(runs, world):
    """``data_axes_of``, ``dp_size`` and ``batch_pspec`` on each mesh shape
    equal JAX's ``configs.cell`` helpers on the same shape."""
    from repro.configs.cell import batch_pspec, data_axes_of, dp_size

    for shape, names in ZERO_MESHES[world]:
        class StubMesh:
            axis_names = names
        StubMesh.shape = dict(zip(names, shape))
        want = (data_axes_of(StubMesh), dp_size(StubMesh), tuple(batch_pspec(StubMesh)),
                tuple(batch_pspec(StubMesh, 2)))
        for res in runs["port"][world]:
            assert res["mesh_helpers"][(shape, names)] == want, (shape, names)


@pytest.mark.parametrize("world", WORLDS)
def test_zero_state_checkpoint_round_trip(runs, world):
    for res in runs["port"][world]:
        assert res["ckpt_ok"] and res["ckpt_params_ok"]


# ------------------------------------------------------------------ GatedGCN


def _graph(batch: dict, lib):
    if lib == "jax":
        return JGraphBatch(**{k: (jnp.asarray(v) if v is not None else None)
                              for k, v in batch.items()})
    return GraphBatch(**{k: (torch.from_numpy(v) if v is not None else None)
                         for k, v in batch.items()})


@pytest.mark.parametrize("key", list(DSTLOCAL_MESHES))
def test_dstlocal_loss_matches_jax(runs, key):
    shape, _ = DSTLOCAL_MESHES[key]
    world = int(np.prod(shape))
    dl = runs["job"]["dstlocal"]
    want_loss, want_grads = runs["jax"]["dstlocal"][key]
    cfg = gatedgcn.GatedGCNConfig(**dl["cfg"])
    params = gatedgcn.params_from_jax(cfg, dl["params"], device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    base = gatedgcn.loss_fn(cfg, params, _graph(dl["batches"][world], "torch"))
    base_grads = torch.autograd.grad(base, leaves, allow_unused=True, materialize_grads=True)
    for r, res in enumerate(runs["port"][world]):
        got = res["dstlocal"][key]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=0, atol=DSTLOCAL_VS_JAX_TOL)
        assert abs(got["loss"] - float(base)) < DSTLOCAL_LOSS_TOL
        assert got["step_loss"] == got["loss"]
        for i, (g, w, b) in enumerate(zip(got["grads"], want_grads, base_grads)):
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= DSTLOCAL_VS_JAX_GRAD_REL * scale, i
            assert float(np.abs(g - b.numpy()).max()) < DSTLOCAL_GRAD_TOL, i
            assert g.tobytes() == runs["port"][world][0]["dstlocal"][key]["grads"][i].tobytes()
        for a, b in zip(tree_leaves(got["params"]), tree_leaves(runs["port"][world][0]
                                                                ["dstlocal"][key]["params"])):
            assert a.tobytes() == b.tobytes()   # the replicated step: the same on every rank


def test_gnn_train_step_matches_jax():
    """``make_gnn_train_step`` = the ``train_step`` of JAX's
    ``gnn_train_cell``, two steps of GatedGCN's ``loss_fn`` in one process."""
    dl = _dstlocal_job(np.random.default_rng(5))
    jcfg = jgatedgcn.GatedGCNConfig(**dl["cfg"])
    cfg = gatedgcn.GatedGCNConfig(**dl["cfg"])
    jparams = jax.tree.map(jnp.asarray, dl["params"])
    jg = _graph(dl["batches"][1], "jax")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    cell = gnn_train_cell("gatedgcn", "full_graph_sm", mesh,
                          loss_fn=lambda p, g: jgatedgcn.loss_fn(jcfg, p, g),
                          init_fn=lambda: jparams)
    params = gatedgcn.params_from_jax(cfg, dl["params"], device="cpu")
    step = make_gnn_train_step(partial(gatedgcn.loss_fn, cfg), None)
    g = _graph(dl["batches"][1], "torch")
    jst, st = jax_adamw_init(jparams), adamw_init(params)
    for _ in range(2):
        jparams, jst, jm = cell.fn(jparams, jst, jg)
        params, st, m = step(params, st, g)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    for a, b in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(st.nu), jax.tree.leaves(jst.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-12)


@pytest.fixture(scope="module")
def gnn_sharded_jax(runs):
    """JAX's loss, gradients (``jax.grad``) and one ``gnn_train_cell`` step
    of each model over the whole graph, in this process."""
    out = {}
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    for name, case in runs["job"]["gnn_sharded"]["models"].items():
        jmod = GNN_SHARDED[name]
        cfg = jax_arch(name).smoke_config()
        params = jax.tree.map(jnp.asarray, case["params"])
        arrays = {k: (jnp.asarray(v) if v is not None else None)
                  for k, v in case["batch"].items()}
        if name == "graphcast":
            b = jgraphcast.MeshBatch(**arrays)
            loss_fn = partial(jmod.loss_fn, cfg, n_mesh=case["n_mesh"])
        else:
            b = JGraphBatch(**arrays)
            loss_fn = partial(jmod.loss_fn, cfg)
        loss, grads = jax.value_and_grad(lambda p: loss_fn(p, b))(params)
        cell = gnn_train_cell(name, "full_graph_sm", mesh, loss_fn=lambda p, g: loss_fn(p, g),
                              init_fn=lambda: params)
        stepped, _, _ = cell.fn(params, jax_adamw_init(params), b)
        out[name] = (float(loss), [np.asarray(x) for x in jax.tree.leaves(grads)],
                     [np.asarray(x) for x in jax.tree.leaves(stepped)])
    return out


@pytest.mark.parametrize("key", list(GNN_SHARDED_MESHES))
@pytest.mark.parametrize("name", list(GNN_SHARDED))
def test_sharded_gnn_loss_matches_jax(runs, gnn_sharded_jax, name, key):
    """A model's per-rank loss over each rank's block of the graph: the
    loss, the gradients and one step's params against JAX's over the whole
    graph, the params the same bytes on every rank; on 2 and 4 ranks the
    control (a gather's adjoint that does not sum over the ranks) exceeds
    the gradients' bound on some leaf."""
    shape, _ = GNN_SHARDED_MESHES[key]
    world = int(np.prod(shape))
    want_loss, want_grads, want_params = gnn_sharded_jax[name]
    first = runs["port"][world][0]["gnn_sharded"][(key, name)]

    def grad_excess(grads):
        return max(float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
                   for g, w in zip(grads, want_grads))

    for r, res in enumerate(runs["port"][world]):
        got = res["gnn_sharded"][(key, name)]
        assert abs(got["loss"] - want_loss) <= GNN_SHARDED_LOSS_REL * abs(want_loss), r
        assert len(got["grads"]) == len(want_grads)
        assert grad_excess(got["grads"]) <= GNN_SHARDED_GRAD_REL, (r, grad_excess(got["grads"]))
        assert got["step_loss"] == got["loss"]
        for i, (a, b) in enumerate(zip(tree_leaves(got["params"]), want_params)):
            np.testing.assert_allclose(a, b, rtol=GNN_SHARDED_STEP_RTOL,
                                       atol=GNN_SHARDED_STEP_ATOL, err_msg=f"{r} {i}")
            assert a.tobytes() == tree_leaves(first["params"])[i].tobytes()
        if world > 1:
            assert grad_excess(got["control"][1]) > GNN_SHARDED_GRAD_REL


# ------------------------------------------------------------------ GPipe


def _jax_sequential(w, x, proj):
    def run(w, x):
        for s in range(w.shape[0]):
            for i in range(w.shape[1]):
                x = jnp.tanh(x @ w[s, i])
        return x

    out = run(w, x)
    gw, gx = jax.grad(lambda w, x: jnp.sum(run(w, x) * proj), argnums=(0, 1))(w, x)
    return np.asarray(out), np.asarray(gw), np.asarray(gx)


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_matches_sequential(runs, world):
    pl = runs["job"]["pipeline"][world]
    out, gw, gx = _jax_sequential(pl["w"], pl["x"], pl["proj"])
    for r, res in enumerate(runs["port"][world]):
        got = res["pipeline"]
        for a, b in ((got["out"], out), (got["ref_out"], out), (got["out"], got["ref_out"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=PIPELINE_TOL)
        # the gradient of each stage's params lands on the rank that owns it
        np.testing.assert_allclose(got["gw"], gw[r], rtol=0, atol=PIPELINE_TOL)
        np.testing.assert_allclose(got["gw"], got["ref_gw"], rtol=0, atol=PIPELINE_TOL)
        # the input's gradient reaches stage 0 only
        want_gx = gx if r == 0 else np.zeros_like(gx)
        np.testing.assert_allclose(got["gx"], want_gx, rtol=0, atol=PIPELINE_TOL)
