"""The paper's own architecture: the reachability oracle at production scale,
the port of ``repro.configs.reachability``.

Cells:
  serve_1m       batched oracle queries: n=10M vertices, L_max=64, 1M-query
                 batch -> the serve step (2 label rows gathered + intersected
                 by K1's tier form)
  serve_xl       n=25M (uniprotenc_150m scale), L_max=32, 1M queries
  build_sweep    one Distribution-Labeling iteration (distribute_one) at
                 n=10M, m=30M: the per-vertex unit of the distributed build
  build_sweep_xl n=25M, m=25M (tree-like, uniprot scale)

Labels shard over the data axes (vertex-partitioned, labels live with their
vertex shard); query batches shard over data; the frontier bitmap is the only
per-step cross-shard exchange in the build sweep.  A cell's ``fn`` is one
rank's program: ``serve.engine.make_row_sharded_serve_step`` and
``core.distribution_device.make_sharded_distribute_one``; on one rank
(``mesh`` None) each is the single-device program.
"""
from __future__ import annotations

import torch

from repro_torch.configs.cell import CellSpec, TensorSpec, data_axes_of
from repro_torch.core.distribution_device import (LabelState, build_sweep_specs,
                                                  make_sharded_distribute_one)
from repro_torch.launch.mesh import P
from repro_torch.serve.engine import make_row_sharded_serve_step

ARCH_ID = "reachability-oracle"
FAMILY = "oracle"
SHAPES = ("serve_1m", "serve_xl", "build_sweep", "build_sweep_xl")

ORACLE_SHAPES = {
    "serve_1m": dict(kind="serve", n=10_000_000, l_max=64, queries=1_000_000),
    "serve_xl": dict(kind="serve", n=25_000_000, l_max=32, queries=1_000_000),
    "build_sweep": dict(kind="build", n=10_000_000, m=30_000_000, l_max=64),
    "build_sweep_xl": dict(kind="build", n=25_000_000, m=25_000_000, l_max=32),
}

# the production sweep's BFS depth bound: real diameters are <= a few
# hundred, deeper graphs re-enter the loop
MAX_STEPS = 64


def full_config():
    return dict(ORACLE_SHAPES)


def smoke_config():
    return dict(n=200, m=500, l_max=16, queries=64)


def row_extract_of(variant: str) -> str:
    """JAX's variants 'rowfix' and 'opt' extract vi's row by the one-hot
    reduction ([L] all-reduce); the baseline gathers it."""
    return "onehot" if variant in ("rowfix", "opt") else "gather"


def cells(shape: str, mesh, variant: str = "baseline") -> CellSpec:
    """The cell of ``shape`` on ``mesh`` (``None``: one rank)."""
    info = ORACLE_SHAPES[shape]
    axes = data_axes_of(mesh)
    lead = axes if len(axes) > 1 else axes[0]
    n, l_max = info["n"], info["l_max"]

    if info["kind"] == "serve":
        B = info["queries"]
        label_spec = TensorSpec((n, l_max), torch.int32)
        q_spec = TensorSpec((B, 2), torch.int32)
        # labels vertex-sharded over the data axes; queries data-sharded; the
        # row gather crosses shards (all-to-all) -- the serve collective
        return CellSpec(
            arch=ARCH_ID, shape=shape, kind="serve", fn=make_row_sharded_serve_step(mesh),
            args=(label_spec, label_spec, q_spec),
            placements=(P(lead, None), P(lead, None), P(lead, None)),
            meta=dict(n=n, l_max=l_max, queries=B),
        )

    # build sweep: one distribute_one iteration at full scale
    m = info["m"]
    sp = build_sweep_specs(n, m, l_max)
    state_p = LabelState(L_out=P(lead, None), L_in=P(lead, None), out_len=P(lead),
                         in_len=P(lead), overflow=P())
    fn = make_sharded_distribute_one(mesh, n, MAX_STEPS, row_extract_of(variant))
    return CellSpec(
        arch=ARCH_ID, shape=shape, kind="build", fn=fn,
        args=(sp["state"], sp["vi"], sp["fwd_src"], sp["fwd_dst"], sp["rev_src"],
              sp["rev_dst"]),
        placements=(state_p, P(), P(lead), P(lead), P(lead), P(lead)),
        out_placements=state_p,
        donate=(0,),
        meta=dict(n=n, m=m, l_max=l_max),
    )
