"""Dry run: trace one rank of every (arch x shape x mesh) cell with no
allocation, the counterpart of ``repro.launch.dryrun``.

Usage (on the CPU; nothing is allocated on any device):
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch reachability-oracle \\
      --shape build_sweep --mesh single --variant rowfix

JAX lowers and compiles each cell's global program for 256 or 512
placeholder devices and reads its partitioned HLO.  Torch has no SPMD
partitioner: a cell's ``fn`` is one rank's program with its collectives
written out (``configs.cell``).  So the dry run forms a ``fake`` process
group of the mesh's world (``torch.distributed``'s fake backend: the
collectives return at once), lays a ``launch.mesh`` mesh over it, makes
``meta`` tensors of rank 0's blocks (``local_specs``) and runs ``fn``
under three counters: ``FlopCounterMode`` (FLOPs), ``CollectiveCounter``
(a ``CommDebugMode``: collective bytes by kind) and ``TraceCounter``
(bytes accessed, the peak of live storage); the kernel wrappers add their
kernels' FLOPs and bytes on ``meta`` (``kernels.ops.META_COST``).

Each cell writes experiments/dryrun_torch/<arch>__<shape>__<mesh>[__variant].json
with JAX's record fields: ``memory`` (``argument_size_in_bytes``: rank 0's
argument bytes, exact; ``temp_size_in_bytes``: the trace's peak of live
storage it made), ``cost`` (``flops``, ``bytes_accessed``), ``collectives``,
``roofline_trace`` and ``roofline`` (from ``meta["analytic"]`` where the
cell has it, as JAX's does, else the trace's), ``status``.  A cell whose
placement does not divide a dimension (JAX's lowering refuses it too) or
that does not apply is ``skipped`` with its reason.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

UNEVEN = ("{err}: JAX's lowering refuses this sharding too (ROADMAP.md Queue 1, item 12.8: "
          "uneven shards)")


def variant_mesh_shape(mesh_kind: str, variant: str) -> tuple:
    """(shape, axis names): the required (16, 16) and (2, 16, 16) meshes,
    or for a variant ``tpN`` the same 256 cards as (256 / N, N), as JAX's
    ``make_variant_mesh``."""
    if variant.startswith("tp"):
        tp = int(variant[2:].split("-")[0])
        assert 256 % tp == 0
        return (256 // tp, tp), ("data", "model")
    return MESHES[mesh_kind]


def fake_mesh(shape: tuple, names: tuple):
    """A ``launch.mesh`` mesh of ``shape`` over a fake process group of its
    world, this process rank 0 (the default group is replaced)."""
    import math

    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers "fake")

    from repro_torch.launch.mesh import form_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=math.prod(shape))
    return form_mesh(shape, names, device_type="cpu")


def trace_cell(cell, mesh) -> dict:
    """Run ``cell.fn`` on meta tensors of rank 0's blocks under the three
    counters; returns the record's ``memory``, ``cost``, ``collectives``,
    ``kernels`` and ``roofline_trace``, and the top ops (``top``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.cell import local_specs, meta_tensors, spec_bytes
    from repro_torch.kernels import ops
    from repro_torch.launch.trace_analysis import (CollectiveCounter, TraceCounter,
                                                   roofline_terms)

    local = local_specs(mesh, cell.args, cell.placements)
    args = meta_tensors(local)
    ops.reset_meta_cost()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, CollectiveCounter() as cc, TraceCounter() as tc:
        out = cell.fn(*args)
    del out
    kernels = {k: dict(v) for k, v in ops.META_COST.items()}
    flops = float(fc.get_total_flops() + sum(v["flops"] for v in kernels.values()))
    nbytes = float(tc.bytes_accessed + sum(v["bytes"] for v in kernels.values()))
    coll = cc.summary()
    counts = {str(k): v for k, v in cc.get_comm_counts().items()}
    return dict(
        trace_s=time.perf_counter() - t0,
        memory=dict(argument_size_in_bytes=spec_bytes(local),
                    temp_size_in_bytes=int(tc.peak)),
        cost=dict(flops=flops, bytes_accessed=nbytes,
                  matmul_flops=float(fc.get_total_flops())),
        collectives=coll, comm_counts=counts, kernels=kernels,
        roofline_trace=roofline_terms(flops, nbytes, coll["total"], 1),
        top=dict(rows=sorted(tc.rows, reverse=True), by_op=dict(tc.by_op), order=cc.order),
    )


def cell_tag(arch_id: str, shape: str, mesh_kind: str, variant: str) -> str:
    return f"{arch_id}__{shape}__{mesh_kind}" + (f"__{variant}" if variant != "baseline" else "")


def run_cell(arch_id: str, shape: str, mesh_kind: str, variant: str, out_dir: str,
             mesh_shape=None) -> dict:
    """One cell's record, written to ``out_dir`` (``None``: not written).
    ``mesh_shape`` ((shape, names)) overrides the mesh the kind and variant
    name."""
    import math

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.cell import UnevenShard, local_specs

    shape_, names = mesh_shape or variant_mesh_shape(mesh_kind, variant)
    tag = cell_tag(arch_id, shape, mesh_kind, variant)
    rec: dict = dict(arch=arch_id, shape=shape, mesh=mesh_kind, variant=variant,
                     n_chips=int(math.prod(shape_)), mesh_shape=list(shape_))
    try:
        mesh = fake_mesh(shape_, names)
        cell = get_arch(arch_id).cells(shape, mesh, variant)
        rec.update(kind=cell.kind, meta=cell.meta)
        if cell.skip is None:
            try:
                local_specs(mesh, cell.args, cell.placements)
            except UnevenShard as e:
                cell.skip = UNEVEN.format(err=e)
        if cell.skip:
            rec["status"] = "skipped"
            rec["skip_reason"] = cell.skip
        else:
            traced = trace_cell(cell, mesh)
            traced.pop("top")
            rec.update(traced)
            ana = cell.meta.get("analytic")
            if ana is not None:
                from repro_torch.launch.trace_analysis import roofline_terms

                rec["roofline"] = roofline_terms(ana["flops"], ana["bytes"], ana["coll"], 1)
                rec["roofline"]["source"] = "analytic"
                rec["model_flops"] = ana.get("model_flops")
            else:
                rec["roofline"] = dict(rec["roofline_trace"])
                rec["roofline"]["source"] = "trace"
                rec["model_flops"] = cell.meta.get("model_flops")
            rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 -- record and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if out_dir is not None:
        _write(out_dir, tag, rec)
    return rec


def _write(out_dir: str, tag: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> None:
    from repro_torch.configs import ALL_ARCHS, get_arch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ALL_ARCHS)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]
    n_ok = n_skip = n_err = 0
    for arch_id in archs:
        mod = get_arch(arch_id)
        shapes = [args.shape] if args.shape else list(mod.SHAPES)
        for shape in shapes:
            for mesh_kind in meshes:
                tag = cell_tag(arch_id, shape, mesh_kind, args.variant)
                path = os.path.join(args.out, f"{tag}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                else:
                    rec = run_cell(arch_id, shape, mesh_kind, args.variant, args.out)
                status = rec["status"]
                n_ok += status == "ok"
                n_skip += status == "skipped"
                n_err += status == "error"
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (
                        f"dom={r['dominant']} comp={r['compute_s']:.2e}s "
                        f"mem={r['memory_s']:.2e}s coll={r['collective_s']:.2e}s "
                        f"trace={rec.get('trace_s', 0):.1f}s"
                    )
                elif status == "error":
                    extra = rec["error"][:160]
                else:
                    extra = rec["skip_reason"][:120]
                print(f"[{status:7s}] {tag}  {extra}", flush=True)
    print(f"\nDRYRUN SUMMARY: ok={n_ok} skipped={n_skip} error={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
