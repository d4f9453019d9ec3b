"""Hillclimb profiler: the top-K ops of one rank's traced cell by result
bytes, the bytes by op, and its collectives in the order the rank issues
them; the counterpart of ``repro.launch.hlo_top``.

  PYTHONPATH=src python -m repro_torch.launch.trace_top --arch gatedgcn \\
      --shape ogb_products --mesh single --variant dstlocal

JAX reads the compiled HLO; the port traces rank 0 of the cell on ``meta``
tensors over a fake process group (``launch.dryrun``): big result tensors
are big HBM traffic, the collective list the wire schedule.  The kernel
wrappers' outputs count as allocations here; their bytes are in the
``kernels`` lines.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import fake_mesh, trace_cell, variant_mesh_shape

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    mesh = fake_mesh(*variant_mesh_shape(args.mesh, args.variant))
    try:
        cell = get_arch(args.arch).cells(args.shape, mesh, args.variant)
        if cell.skip:
            print(f"skipped: {cell.skip}")
            return
        traced = trace_cell(cell, mesh)
    finally:
        dist.destroy_process_group()
    top = traced["top"]
    print(f"== top {args.top} ops by result bytes ({args.arch}/{args.shape}/{args.variant}) ==")
    for b, name in top["rows"][:args.top]:
        print(f"{b / 1e6:10.1f} MB  {name}")
    print("\n== bytes by op ==")
    for name, b in sorted(top["by_op"].items(), key=lambda kv: -kv[1])[:12]:
        print(f"{b / 1e9:10.3f} GB  {name}")
    print("\n== kernels (on meta: their bound formulas) ==")
    for name, c in traced["kernels"].items():
        print(f"{c['bytes'] / 1e9:10.3f} GB  {c['flops'] / 1e9:12.3f} GFLOP  "
              f"{c['calls']:6d} calls  {name}")
    print(f"\n== collectives in order ({len(top['order'])}) ==")
    for kind, b in top["order"][:args.top]:
        print(f"{b / 1e6:10.3f} MB  {kind}")


if __name__ == "__main__":
    main()
