"""Run one cell of the benchmark on this machine's card and print its result.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Progress and the compared numbers go to
standard error; the last line of standard output is the result, one JSON
object.  Without a CUDA card, or with fewer than the cell asks for, it exits
with code 2 and prints no result; with JAX or the JAX package loaded once
the window has closed, with code 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the checkout and the program in place of this script's own directory
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    import torch
    t_torch = time.perf_counter()

    from bench.harness import ForeignModules, execute
    from bench.manifest import Manifest

    manifest = Manifest(ROOT)
    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"{args.workload}: torch imported at {t_torch - T_START:.3f} s, the card set at "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    try:
        result = execute(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                         device, T_START)
    except ForeignModules as e:
        print(e, file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
