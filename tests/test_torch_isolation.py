"""``repro_torch`` stands alone and runs on the card unless told otherwise.

  * importing every module of the port (training across ranks and the
    frontier-vector BFS among them) loads neither ``jax`` nor any module of
    the JAX package ``repro`` (checked in a fresh interpreter);
  * the entry points (the dynamic oracle's, the chaos driver's and the
    substrate models' too) raise
    ``RuntimeError`` on a box without CUDA unless the caller passes
    ``device="cpu"``;
  * the serve driver runs end to end with ``--device cpu``.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.graph.csr as tcsr
from repro_torch.core.api import build_oracle
from repro_torch.core.oracle import oracle_from_arrays
from repro_torch.launch import serve as tserve
from repro_torch.serve.engine import QueryEngine

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
# the modules of the device wave build, of the host engines' build
# checkpoints, of oracle snapshots, the WAL and the budget tier must be
# among them
for name in ("repro_torch.build.bitset", "repro_torch.build.waves",
             "repro_torch.build.engine_device", "repro_torch.kernels.ops",
             "repro_torch.kernels.ref", "repro_torch.kernels.build",
             "repro_torch.persist", "repro_torch.persist.blocks",
             "repro_torch.persist.oracle_io", "repro_torch.persist.wal",
             "repro_torch.serve.budget",
             # Hierarchical-Labeling, the backbone, the §6 baselines, the
             # daemon and its open-loop driver
             "repro_torch.core.hierarchy", "repro_torch.core.backbone",
             "repro_torch.core.baselines.grail", "repro_torch.core.baselines.interval",
             "repro_torch.core.baselines.kreach", "repro_torch.core.baselines.pwah",
             "repro_torch.core.baselines.twohop", "repro_torch.serve.daemon",
             "repro_torch.serve.openloop", "repro_torch.dynamic.workload",
             # the dynamic oracle, its durable form and the chaos driver
             "repro_torch.dynamic", "repro_torch.dynamic.delta",
             "repro_torch.dynamic.repair", "repro_torch.dynamic.versioned",
             "repro_torch.dynamic.durable", "repro_torch.launch.chaos",
             # the multi-device modes and the vertex-wise device DL
             "repro_torch.launch.mesh", "repro_torch.core.distribution_device",
             # the substrate's serving paths: the LM family and xDeepFM on K4
             # and K6, and the architecture registry
             "repro_torch.models", "repro_torch.models.transformer",
             "repro_torch.models.recsys", "repro_torch.models.recsys.xdeepfm",
             "repro_torch.configs", "repro_torch.configs.lm_cells",
             "repro_torch.configs.granite_3_2b", "repro_torch.configs.h2o_danube_1_8b",
             "repro_torch.configs.deepseek_7b", "repro_torch.configs.granite_moe_1b_a400m",
             "repro_torch.configs.deepseek_v2_lite_16b", "repro_torch.configs.xdeepfm_cfg",
             # training: the optimizer, checkpoints, the loop, trees, the driver
             "repro_torch.tree", "repro_torch.optim", "repro_torch.optim.adamw",
             "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt", "repro_torch.ft.loop",
             "repro_torch.launch.train", "repro_torch.data.synth",
             # training across ranks and the frontier-vector BFS
             "repro_torch.configs.cell", "repro_torch.configs.gnn_cells",
             "repro_torch.optim.compression", "repro_torch.dist", "repro_torch.dist.pipeline",
             "repro_torch.graph.partition", "repro_torch.graph.bfs"):
    assert name in names, name
from repro_torch.core.api import oracle_from_snapshot
from repro_torch.core import hierarchical_labeling
from repro_torch.core.baselines import Grail, IntervalTC, KReach, PWAHBitvector, TwoHopSetCover
from repro_torch.serve import ServeDaemon, run_open_loop
from repro_torch.serve import BudgetController, TruncatedStore
from repro_torch.persist import WriteAheadLog, load_budgeted, load_epoch, save_epoch
from repro_torch.dynamic import DurableDynamicOracle, DynamicOracle, LabelEpoch
from repro_torch.build.engine import cone_resume_sweep
from repro_torch.core import distribution_labeling_torch, oracle_from_snapshot
from repro_torch.serve import make_hop_sharded_serve_step, make_sharded_serve_step
from repro_torch.configs import ALL_ARCHS, get_arch
for arch in ALL_ARCHS:
    get_arch(arch).full_config()
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_schedule, global_norm
from repro_torch.optim import quantized_psum_grads, zero_gather, zero_init, zero_shard, zero_update
from repro_torch.dist import pipeline_apply
from repro_torch.configs.lm_cells import make_train_step, opt_layout
from repro_torch.configs.gnn_cells import make_gnn_train_step
from repro_torch.models.gnn.gatedgcn import make_dstlocal_loss
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.ft import FaultTolerantLoop
from repro_torch.data.synth import lm_batch, recsys_batch
from repro_torch.models.transformer import lm_loss
from repro_torch.models.recsys.xdeepfm import loss_fn
# the kernel library's wrappers and the backwards', and a build entry for every CUDA source
from repro_torch.kernels import build, ops
for fn in ("bitset_mm", "flash_attention", "ell_spmm", "embedding_bag", "flash_attention_bwd",
           "embedding_bag_bwd"):
    assert callable(getattr(ops, fn)) and fn in ops.LAUNCHES, fn
assert "ell_spmm_bwd" in ops.LAUNCHES
assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(build.SIGNATURES)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_importing_every_module_loads_no_jax_and_no_repro():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 56, r.stdout


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a box without CUDA")


def test_build_oracle_refuses_without_cuda():
    _no_cuda()
    g = tcsr.from_edges(4, [0, 1], [1, 2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_oracle(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_oracle(g, device="cuda:0")
    assert build_oracle(g, device="cpu").serve(np.array([[0, 2], [2, 0]])).tolist() == [True, False]


def test_query_engine_refuses_without_cuda():
    _no_cuda()
    z = np.full((3, 8), -1, np.int32)
    o = oracle_from_arrays(z, z, np.zeros(3, np.int32), np.zeros(3, np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(o)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        o.device_labels("cuda")
    assert QueryEngine(o, device="cpu").backend == "dense"


def test_serve_driver_refuses_without_cuda():
    _no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--dataset", "kegg", "--scale", "0.05", "--n-queries", "100"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--mode", "daemon", "--dataset", "kegg", "--scale", "0.05"])


def test_dynamic_entry_points_refuse_without_cuda(tmp_path):
    _no_cuda()
    from repro_torch.dynamic import DurableDynamicOracle, DynamicOracle
    from repro_torch.launch import chaos
    from repro_torch.persist import load_epoch

    g = tcsr.from_edges(4, [0, 1], [1, 2])
    for call in (lambda: DynamicOracle(g),
                 lambda: DurableDynamicOracle(g, state_dir=str(tmp_path / "s")),
                 lambda: DurableDynamicOracle.recover(str(tmp_path / "s")),
                 lambda: load_epoch(str(tmp_path / "e")),
                 lambda: chaos.main([]),
                 lambda: tserve.main(["--dataset", "kegg", "--scale", "0.05",
                                      "--state-dir", str(tmp_path / "d")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert DynamicOracle(g, device="cpu").query(0, 2)


def test_substrate_entry_points_refuse_without_cuda():
    """The LM family's and xDeepFM's entry points that make tensors default
    to the card; with ``device="cpu"`` they run."""
    _no_cuda()
    from repro_torch.configs import granite_3_2b, xdeepfm_cfg
    from repro_torch.models import transformer
    from repro_torch.models.recsys import xdeepfm

    lm, rs = granite_3_2b.smoke_config(), xdeepfm_cfg.smoke_config()
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: transformer.init_params(lm, gen),
                 lambda: transformer.init_cache(lm, 1, 8),
                 lambda: transformer.params_from_jax(lm, {}),
                 lambda: xdeepfm.init_params(rs, gen),
                 lambda: xdeepfm.params_from_jax(rs, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params = transformer.init_params(lm, gen, device="cpu")
    cache = transformer.init_cache(lm, 1, 8, device="cpu")
    logits, _ = transformer.decode_step(lm, params, cache, torch.zeros((1, 1), dtype=torch.int32))
    assert logits.device.type == "cpu" and cache["pos"] == 1
    p = xdeepfm.init_params(rs, gen, device="cpu")
    assert xdeepfm.forward(rs, p, torch.zeros((2, rs.n_fields), dtype=torch.int32)).shape == (2,)


def test_training_entry_points_refuse_without_cuda():
    """The training driver and the synthetic batches default to the card;
    with ``--device cpu`` / ``device="cpu"`` they run."""
    _no_cuda()
    from repro_torch.data.synth import lm_batch, recsys_batch
    from repro_torch.launch import train

    for call in (lambda: train.main(["--arch", "gcn-cora", "--smoke", "--steps", "1"]),
                 lambda: lm_batch(0, 0, 2, 8, 100),
                 lambda: recsys_batch(0, 0, 2, 3, 100)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    log = train.main(["--arch", "gcn-cora", "--smoke", "--steps", "1", "--device", "cpu"])
    assert len(log) == 1 and log[0]["loss"] > 0


def test_serve_driver_runs_on_cpu(tmp_path):
    out = tmp_path / "serve.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--dataset", "kegg", "--scale", "1.0", "--n-queries", "2000",
         "--backend", "all", "--json-out", str(out)],
        env=_env(), capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    for be in ("host", "dense", "kernel"):
        assert f"[{be}] correctness sample: 200/200 ok" in r.stdout
    import json

    rec = json.loads(out.read_text())
    assert rec["torch_device"] == "cpu" and set(rec["backends"]) == {"host", "dense", "kernel"}
