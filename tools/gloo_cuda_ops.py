"""Which collectives gloo takes on CUDA tensors, on this machine's card.

    python3 tools/gloo_cuda_ops.py

Starts two gloo ranks on the one card (each a process, meeting through a
file store in a temporary directory) and tries each collective that
``repro_torch.launch.mesh`` could be written on, on int32 and uint8 CUDA
tensors, checking the result; prints one JSON line: each op, whether it
ran and gave the right answer, and the error of those that did not.  The
multi-device modes use ``all_reduce`` MAX and ``all_gather_into_tensor``,
which NCCL takes too.  Exits non-zero without a card.
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile


def _ops(dist, torch, rank: int, world: int) -> dict:
    dev = torch.device("cuda", 0)
    res = {}

    def attempt(name, fn):
        try:
            res[name] = {"ok": bool(fn())}
        except Exception as e:  # what gloo refuses, recorded, not raised
            res[name] = {"ok": False, "error": f"{type(e).__name__}: {str(e)[:200]}"}

    for dtype in (torch.int32, torch.uint8):
        tag = str(dtype).split(".")[-1]

        def reduce(op, want):
            t = torch.full((4,), rank + 1, dtype=dtype, device=dev)
            dist.all_reduce(t, op=op)
            return bool((t == want).all())

        attempt(f"all_reduce_sum_{tag}", lambda: reduce(dist.ReduceOp.SUM, world * (world + 1) // 2))
        attempt(f"all_reduce_max_{tag}", lambda: reduce(dist.ReduceOp.MAX, world))

        def broadcast():
            t = torch.full((4,), rank + 7, dtype=dtype, device=dev)
            dist.broadcast(t, src=0)
            return bool((t == 7).all())

        def all_gather():
            parts = [torch.empty(4, dtype=dtype, device=dev) for _ in range(world)]
            dist.all_gather(parts, torch.full((4,), rank, dtype=dtype, device=dev))
            return all(bool((p == r).all()) for r, p in enumerate(parts))

        def all_gather_into_tensor():
            out = torch.empty(4 * world, dtype=dtype, device=dev)
            dist.all_gather_into_tensor(out, torch.full((4,), rank, dtype=dtype, device=dev))
            return bool((out.view(world, 4) == torch.arange(world, device=dev)[:, None]).all())

        def reduce_scatter_tensor():
            out = torch.empty(4, dtype=dtype, device=dev)
            dist.reduce_scatter_tensor(out, torch.ones(4 * world, dtype=dtype, device=dev))
            return bool((out == world).all())

        attempt(f"broadcast_{tag}", broadcast)
        attempt(f"all_gather_{tag}", all_gather)
        attempt(f"all_gather_into_tensor_{tag}", all_gather_into_tensor)
        attempt(f"reduce_scatter_tensor_{tag}", reduce_scatter_tensor)
    return res


def _rank(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=30))
    try:
        res = _ops(dist, torch, rank, world)
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def main() -> int:
    import multiprocessing

    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_ops: torch sees no CUDA device", file=sys.stderr)
        return 1
    world = 2
    with tempfile.TemporaryDirectory(prefix="gloo_cuda_ops_") as tmp:
        ctx = multiprocessing.get_context("spawn")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [ctx.Process(target=_rank, args=(r, world, os.path.join(tmp, "store"), outs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
            if p.is_alive():
                p.kill()
        if any(p.exitcode != 0 for p in procs):
            print(f"gloo_cuda_ops: a rank failed: {[p.exitcode for p in procs]}", file=sys.stderr)
            return 1
        res = [json.load(open(o)) for o in outs]
    ok = {k: all(r[k]["ok"] for r in res) for k in res[0]}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      "ops": {k: {"ok": ok[k], **({"error": res[0][k]["error"]}
                                                   if "error" in res[0][k] else {})}
                              for k in res[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
