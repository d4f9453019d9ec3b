"""The port's dry-run cells (``repro_torch.configs.*.cells``) against the
JAX package's, and the oracle's cells against JAX's serve and build steps.

A subprocess with 512 placeholder CPU devices builds JAX's ``CellSpec`` of
every arch x shape on the ``single``, ``multi`` and ``tp1`` meshes, without
lowering them, and dumps each argument leaf's global shape, dtype and
``PartitionSpec``, ``skip``, ``meta``, ``donate_argnums`` and
``spec_bytes``.  The port builds its cells on fake process groups of the
same meshes (``launch.dryrun.fake_mesh``) and must match leaf for leaf.
The port adds no skip of its own (``PORT_SKIPS`` is empty): the LM train
and prefill cells (tensor parallelism over ``"model"``), every decode cell
(its cache split by kv heads, along ``head_dim`` or ``kv_lora`` over
``"model"``, along its sequence over the data ranks, or both), the GNN and
xDeepFM cells run wherever JAX's do.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS, get_arch
from repro_torch.configs import reachability
from repro_torch.configs.cell import TensorSpec, map_specs, spec_bytes
from repro_torch.core.distribution_device import (build_sweep_specs, init_state,
                                                  make_sharded_distribute_one)
from repro_torch.core.order import get_order
from repro_torch.graph.csr import from_edges
from repro_torch.graph.generators import layered_dag, random_dag, tree_dag
from repro_torch.launch.dryrun import fake_mesh, variant_mesh_shape
from repro_torch.serve.engine import make_row_sharded_serve_step
from repro_torch.tree import tree_leaves

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
MESHES = (("single", "baseline"), ("multi", "baseline"), ("single", "tp1"))
# the skips the port adds to JAX's: none since decode runs over every cache
# placement (ROADMAP.md Queue 1, items 12.10 and 12.9)
PORT_SKIPS = ()
# the families whose every cell has JAX's skip (None on every mesh here)
NO_PORT_SKIP = ("gcn-cora", "gatedgcn", "schnet", "graphcast", "xdeepfm")

JAX_DUMP = r"""
import json, sys
import jax
from jax.sharding import NamedSharding
from repro.configs import ALL_ARCHS, get_arch
from repro.configs.cell import spec_bytes
from repro.launch.dryrun import make_variant_mesh

def spec(sh):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(sh.spec)]

out = {}
for mesh_kind, variant in %s:
    mesh = make_variant_mesh(mesh_kind, variant)
    for arch in ALL_ARCHS:
        mod = get_arch(arch)
        for shape in mod.SHAPES:
            c = mod.cells(shape, mesh, variant)
            leaves = []
            if c.args:
                jax.tree.map(lambda sh, sub: leaves.extend(
                    [list(l.shape), str(l.dtype), spec(sh)] for l in jax.tree.leaves(sub)),
                    c.in_shardings, c.args, is_leaf=lambda x: isinstance(x, NamedSharding))
            out["|".join((arch, shape, mesh_kind, variant))] = dict(
                kind=c.kind, skip=c.skip, meta=c.meta, leaves=leaves,
                donate=list(c.donate_argnums), bytes=spec_bytes(c.args) if c.args else 0)
json.dump(out, open(sys.argv[1], "w"), default=str)
""" % (MESHES,)


class _Leaf:
    def __init__(self, s, p):
        self.row = [list(s.shape), str(s.dtype).removeprefix("torch."),
                    [list(e) if isinstance(e, tuple) else e for e in p]]


def _leaves(cell) -> list:
    if not cell.args:
        return []
    return [x.row for x in tree_leaves(map_specs(_Leaf, cell.args, cell.placements))]


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("cells") / "jax.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.Popen([sys.executable, "-c", JAX_DUMP, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def jax_records(jax_cells):
    proc, path = jax_cells
    log = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, log[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def port_records(jax_cells):
    """The port's cells on fake meshes, built while JAX's subprocess runs."""
    import torch.distributed as dist

    out = {}
    try:
        for mesh_kind, variant in MESHES:
            mesh = fake_mesh(*variant_mesh_shape(mesh_kind, variant))
            for arch in ALL_ARCHS:
                mod = get_arch(arch)
                for shape in mod.SHAPES:
                    c = mod.cells(shape, mesh, variant)
                    out["|".join((arch, shape, mesh_kind, variant))] = dict(
                        kind=c.kind, skip=c.skip, meta=json.loads(json.dumps(c.meta, default=str)),
                        leaves=_leaves(c), donate=list(c.donate),
                        bytes=spec_bytes(c.args), fn=c.fn is not None)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cells_match_jax(arch, jax_records, port_records):
    """Every cell of ``arch`` on the three meshes: kind, argument leaves
    (global shape, dtype, PartitionSpec), donated arguments, spec bytes and
    meta equal JAX's; JAX's skips are the port's, and the port adds none
    (``PORT_SKIPS``): every cell JAX runs has a ``fn``."""
    keys = [k for k in jax_records if k.startswith(arch + "|")]
    assert keys and set(keys) == {k for k in port_records if k.startswith(arch + "|")}
    for key in keys:
        j, p = jax_records[key], port_records[key]
        assert (p["kind"], p["donate"], p["leaves"], p["bytes"]) == (
            j["kind"], j["donate"], j["leaves"], j["bytes"]), key
        assert p["meta"] == j["meta"], key
        assert p["skip"] == j["skip"], key
        assert not PORT_SKIPS and p["fn"] == (p["skip"] is None), key


def test_port_skips_are_the_listed_ones(port_records, jax_records):
    """Where the port runs a cell and where it skips: on ``single`` and
    ``multi`` (model 16) every LM train_4k, prefill_32k and decode_32k cell
    runs (deepseek-7b's cache by kv heads, the other four's along
    ``head_dim`` or ``kv_lora``: item 12.10) and so does danube's long_500k
    (batch 1: the cache along its sequence over the data ranks and along
    ``head_dim``, items 12.9 and 12.10); the 4 cells left skipped are JAX's
    own long_500k notes.  On ``tp1`` (model 1, 256 data ranks) the LM train
    cells run and so do the 6 decode cells whose batch is smaller than the
    data ranks (item 12.9).  Every GNN cell (the data-sharded losses) and
    every xDeepFM cell (the tables row-sharded over ``"model"``) has JAX's
    skip on all three meshes, as every oracle cell does."""
    run = {k for k, r in port_records.items() if r["skip"] is None}
    assert "granite-3-2b|train_4k|single|tp1" in run
    lm = [a for a in ALL_ARCHS if get_arch(a).FAMILY == "lm"]
    assert len(lm) == 5
    for mk in ("single", "multi"):
        tag = f"|{mk}|baseline"
        for arch in lm:
            for shape in ("train_4k", "prefill_32k"):
                assert f"{arch}|{shape}{tag}" in run, (arch, shape, mk)
            assert f"{arch}|decode_32k{tag}" in run, (arch, mk)
        assert f"h2o-danube-1.8b|long_500k{tag}" in run
        ok = sum(k.endswith(tag) for k in run)
        skipped = [k for k in port_records if k.endswith(tag) and k not in run]
        assert (ok, len(skipped)) == (40, 4), (mk, ok, skipped)
        assert all("DESIGN.md" in port_records[k]["skip"] and "|long_500k|" in k
                   for k in skipped), skipped
    seq_split = [f"{arch}|decode_32k|single|tp1" for arch in lm] + [
        "h2o-danube-1.8b|long_500k|single|tp1"]
    assert set(seq_split) <= run and len(seq_split) == 6
    for key, rec in port_records.items():
        if key.startswith(NO_PORT_SKIP + ("reachability-oracle",)):
            assert rec["skip"] == jax_records[key]["skip"], key
    for mk, var in MESHES:
        for shape in reachability.SHAPES:
            assert f"reachability-oracle|{shape}|{mk}|{var}" in run
        for arch in NO_PORT_SKIP:
            for shape in get_arch(arch).SHAPES:
                assert f"{arch}|{shape}|{mk}|{var}" in run, (arch, shape, mk)


def test_oracle_config_and_build_sweep_specs_match_jax():
    from jax import numpy as jnp

    from repro.configs import reachability as jr
    from repro.configs.cell import spec_bytes as jax_spec_bytes
    from repro.core.distribution_jax import build_sweep_specs as jax_specs

    assert (reachability.ARCH_ID, reachability.FAMILY, reachability.SHAPES) == (
        jr.ARCH_ID, jr.FAMILY, jr.SHAPES)
    assert reachability.ORACLE_SHAPES == jr.ORACLE_SHAPES
    assert reachability.full_config() == jr.full_config()
    assert reachability.smoke_config() == jr.smoke_config()
    for n, m, L in ((10_000_000, 30_000_000, 64), (200, 500, 16)):
        mine, theirs = build_sweep_specs(n, m, L), jax_specs(n, m, L)
        assert set(mine) == set(theirs)
        for k in mine:
            a = [(x.shape, str(x.dtype).removeprefix("torch.")) for x in tree_leaves(mine[k])]
            b = [(tuple(x.shape), str(x.dtype)) for x in __import__("jax").tree.leaves(theirs[k])]
            assert a == b, k
        assert spec_bytes(mine) == jax_spec_bytes(theirs)
    assert TensorSpec((3, 5), torch.bfloat16).nbytes == 30 == jnp.zeros((3, 5), jnp.bfloat16).nbytes


def _families(rng):
    """``tests/test_serve_engine.py``'s five graph families (the port's
    generators, which equal JAX's)."""
    fams = [("random_dag", random_dag(70, 200, seed=1)),
            ("layered_dag", layered_dag(80, avg_out=2.5, seed=2)),
            ("tree_dag", tree_dag(90, branching=4, seed=3))]
    for name, n, hi, m in (("cyclic", 60, 60, 170), ("isolated", 80, 40, 60)):
        fams.append((name, from_edges(n, rng.integers(0, hi, m), rng.integers(0, hi, m))))
    return fams


@pytest.mark.parametrize("family", range(5))
@pytest.mark.parametrize("row_extract", ["gather", "onehot"])
def test_oracle_cells_at_smoke_equal_jax(family, row_extract):
    """The build cell's program (``make_sharded_distribute_one`` on one
    rank) over every vertex of the §5.2 order at ``smoke_config``'s L_max
    equals JAX's ``distribute_one`` state after every iteration, exactly;
    the serve cell's program then answers ``smoke_config``'s queries as
    JAX's ``serve_step`` does."""
    import jax.numpy as jnp

    from repro.core.distribution_jax import distribute_one, init_state as jax_init
    from repro.serve.engine import serve_step

    name, g = _families(np.random.default_rng(0))[family]
    smoke = reachability.smoke_config()
    n, L = g.n, smoke["l_max"]
    fs, fd = g.edges()
    rs, rd = g.reverse().edges()
    edges = [np.asarray(x, np.int32) for x in (fs, fd, rs, rd)]
    step = make_sharded_distribute_one(None, n, reachability.MAX_STEPS, row_extract)
    mine, theirs = init_state(n, L, device="cpu"), jax_init(n, L)
    te = [torch.from_numpy(e) for e in edges]
    je = [jnp.asarray(e) for e in edges]
    for vi in get_order(g, "degree_product"):
        mine = step(mine, torch.tensor(int(vi), dtype=torch.int32), *te)
        theirs = distribute_one(theirs, jnp.int32(vi), *je, n=n,
                                max_steps=reachability.MAX_STEPS, row_extract=row_extract)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} {vi}")
    rng = np.random.default_rng(family)
    q = rng.integers(0, n, (smoke["queries"], 2)).astype(np.int32)
    got = make_row_sharded_serve_step(None)(mine.L_out, mine.L_in, torch.from_numpy(q))
    want = serve_step(theirs.L_out, theirs.L_in, jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
