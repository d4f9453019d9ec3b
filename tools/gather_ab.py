"""Two ways to gather row blocks over a mesh, timed on the card.

    python3 tools/gather_ab.py [--reps 2000]

``repro_torch.launch.mesh.gather_rows`` stacks every rank's block with one
``all_gather_into_tensor``; it used to write its block into a zero-filled
buffer of every rank's blocks and ``all_reduce`` SUM it.  This script times
both over a one-rank NCCL mesh on one card (the mesh of ``chip_smoke.py``
phase 4i (a)): each gather alone, at the two shapes the sharded backends
give it (a batch's bool verdicts, 4,096; ``sharded_hop``'s gathered
``L_in`` block, [1, 4,096, 8] int32), and the whole ``sharded`` and
``sharded_hop`` steps on random citeseer@1.0-shaped labels (693,947 rows,
16 and 8 wide), each call followed by the copy of its result to the host,
as the engine does.  The two versions alternate in rounds of 100 calls;
prints one JSON line of host-clock medians in ms a call, with the card's
name and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import datetime
import json
import subprocess
import sys
import time


def _sum_into_zeros(part, ag):
    """``gather_rows`` as it was: an ``all_reduce`` SUM into zeros."""
    import torch
    import torch.distributed as dist

    wire = torch.uint8 if part.dtype == torch.bool else part.dtype
    buf = torch.zeros((ag.size,) + tuple(part.shape), dtype=wire, device=part.device)
    buf[ag.index].copy_(part)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=ag.group)
    buf = buf.reshape((ag.size * part.shape[0],) + tuple(part.shape[1:]))
    return buf.bool() if part.dtype == torch.bool else buf


def main(argv=None) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    from repro_torch.serve import engine

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = tmesh.form_mesh((1, 1), ("data", "model"))
        ag = tmesh.axis_group(mesh, ("data",))
        rng = np.random.default_rng(0)
        n = 693_947
        lo = torch.from_numpy(np.sort(rng.integers(0, n, (n, 16)), 1).astype(np.int32)).to(dev)
        li = torch.from_numpy(np.sort(rng.integers(0, n, (n, 8)), 1).astype(np.int32)).to(dev)
        q = torch.from_numpy(rng.integers(0, n, (4096, 2)).astype(np.int32)).to(dev)
        hits = torch.rand(4096, device=dev) < 0.5
        block = torch.randint(0, n, (1, 4096, 8), dtype=torch.int32, device=dev)
        gathers = {"all_gather_into_tensor": tmesh.gather_rows, "sum_into_zeros": _sum_into_zeros}
        calls = {}
        for name, gather in gathers.items():
            tmesh.gather_rows = gather          # the step factories import it when called
            s_fn = engine.make_sharded_serve_step(mesh, data_axes=("data",))[0]
            h_fn = engine.make_hop_sharded_serve_step(mesh, data_axes=("data",))[0]
            calls[name] = {
                "gather_bool_4096": lambda g=gather: g(hits, ag),
                "gather_int32_1x4096x8": lambda g=gather: g(block, ag),
                "sharded_step": lambda f=s_fn: f(lo, li, q),
                "sharded_hop_step": lambda f=h_fn: f(lo, li, q),
            }
        tmesh.gather_rows = gathers["all_gather_into_tensor"]
        times = {name: {k: [] for k in c} for name, c in calls.items()}
        for name in calls:                      # warm-up: communicators, blocks, kernels
            for fn in calls[name].values():
                fn().cpu()
        for _ in range(max(args.reps // 100, 1)):
            for name, c in calls.items():
                for k, fn in c.items():
                    for _ in range(100):
                        t0 = time.perf_counter()
                        fn().cpu()
                        times[name][k].append(time.perf_counter() - t0)
        for k in calls["sum_into_zeros"]:
            a, b = calls["sum_into_zeros"][k](), calls["all_gather_into_tensor"][k]()
            if not torch.equal(a, b):
                print(f"gather_ab: the two gathers differ in {k}", file=sys.stderr)
                return 1
    finally:
        dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__, "calls": len(times[name][k]),
                      "median_ms": {name: {k: float(np.median(v)) * 1e3 for k, v in t.items()}
                                    for name, t in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
