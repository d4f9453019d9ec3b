"""Time an LM's decode steps on one card, from the package of a given checkout.

    python3 tools/decode_steps.py [--src DIR] [--arch granite-3-2b] [--layers 6]
                                  [--batch 2] [--tokens 64] [--start 0]
                                  [--dtype float32] [--seed 0]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so that
two checkouts are timed on one card by one command each, in turns (parent,
change, change, parent).  The model is ``full_config()`` of ``--arch`` at
``--layers`` of its layers in ``--dtype``, its weights random from
``--seed``; its cache holds ``--start + --tokens`` positions, the first
``--start`` filled with random keys and values; then ``--tokens`` decode
steps of ``--batch`` random tokens, each synchronised and timed on the host
clock.  The defaults are ``chip_smoke.py`` phase 4j's float32 decode
(granite-3-2b at 6 layers, 2 x 64 tokens from an empty cache).  Prints one
JSON line: the arguments, each step's ms and their median, the kernel
launches a step (``ops.LAUNCHES``) and the card's name and power limit.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=pathlib.Path, default=ROOT,
                    help="the checkout whose src/repro_torch is timed")
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve() / "src"))

    import torch

    if not torch.cuda.is_available():
        print("decode_steps: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    device = torch.device("cuda", 0)
    full = get_arch(args.arch).full_config()
    cfg = dataclasses.replace(full, n_layers=min(full.n_layers, args.layers),
                              dtype=getattr(torch, args.dtype))
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = tf.init_params(cfg, gen, device)
    cache = tf.init_cache(cfg, args.batch, args.start + args.tokens, device)
    for k in cache:
        if k != "pos":
            cache[k][..., :args.start, :].copy_(torch.randn(
                cache[k][..., :args.start, :].shape, generator=gen, device=device))
    cache["pos"] = args.start
    toks = torch.randint(0, cfg.vocab, (args.batch, args.tokens), generator=gen,
                         device=device, dtype=torch.int32)
    ms = []
    torch.cuda.synchronize()
    ops.reset_launches()
    for t in range(args.tokens):
        t0 = time.perf_counter()
        tf.decode_step(cfg, params, cache, toks[:, t:t + 1])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v / args.tokens for k, v in ops.LAUNCHES.items() if v}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"src": str(args.src), "arch": args.arch, "layers": cfg.n_layers,
                      "dtype": args.dtype, "batch": args.batch, "start": args.start,
                      "tokens": args.tokens, "ms_a_step_median": sorted(ms)[len(ms) // 2],
                      "ms": ms, "launches_a_step": launches, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
