"""The readings that the limits of ``correct`` are set from, for one cell on
a card: the program's over short windows, and the control's, the plain
reference put in the program's place with one of the configuration's
guarantees broken (a build whose BFS stops one level early).  One JSON line a seed and side.

    python3 bench/control.py --workload <name> --seeds 1 2 3 [--program-seconds 2]

The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(manifest, workload: str, seed: int, device, program_seconds: float) -> list:
    """[(side, checks)] of ``workload`` on ``seed``: the control's, then with
    ``program_seconds`` the program's over a window that long."""
    from bench import profiling

    cell = manifest.workload(workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    driver = manifest.driver(traffic["driver"])
    out = []
    state = driver.setup(config, traffic, seed, device, program=False)
    driver.control(state)
    out.append(("control", driver.check(state, False)[0]))
    del state
    gc.collect()
    if program_seconds:
        state = driver.setup(config, traffic, seed, device)
        driver.window(state, program_seconds, profiling.marker(False))
        out.append(("program", driver.check(state, False)[0]))
        del state
        gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    # the checkout and the program in place of this script's own directory
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.manifest import Manifest

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    manifest = Manifest(ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for side, checks in readings(manifest, args.workload, seed, device,
                                     args.program_seconds):
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "checks": checks, "s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
