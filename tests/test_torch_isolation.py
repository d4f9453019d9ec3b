"""``repro_torch`` stands alone and runs on the card unless told otherwise.

  * importing every module of the port loads neither ``jax`` nor any module
    of the JAX package ``repro`` (checked in a fresh interpreter);
  * the entry points raise ``RuntimeError`` on a box without CUDA unless the
    caller passes ``device="cpu"``;
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
    assert n_modules >= 25, r.stdout


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
