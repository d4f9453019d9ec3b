"""Oracle serving driver of the port: closed-loop backend sweeps.

  python -m repro_torch.launch.serve --dataset citeseer --scale 0.02 \
      --n-queries 100000 --batch 4096 --backend all

Builds the oracle on ``--device`` (default ``cuda``; ``--device cpu`` runs
the dense/kernel backends' plain torch paths on the CPU), streams uniform
random queries through each backend, and checks a BFS correctness sample.
Exits non-zero when a sampled verdict is wrong or a degradation counter
moved (this driver injects no faults, so a clean run degrades nothing).
The JAX driver's daemon mode, snapshot/state-dir lifecycle and fault flags
come with their slices of the port (ROADMAP.md Queue 1 items 6-8).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.api import build_oracle
from repro_torch.device import resolve_device
from repro_torch.graph.generators import paper_dataset_analogue, random_dag
from repro_torch.graph.reach import reachable_set
from repro_torch.serve.engine import BACKENDS, select_backend


def make_graph(args):
    g = (
        paper_dataset_analogue(args.dataset, scale=args.scale)
        if args.dataset != "random"
        else random_dag(20000, 50000, seed=args.seed)
    )
    print(f"graph: n={g.n} m={g.m}")
    return g


def build(args, g):
    t0 = time.perf_counter()
    co = build_oracle(g, bucketing=not args.no_bucketing, device=args.device)
    t_build = time.perf_counter() - t0
    print(
        f"DL build: {t_build:.2f}s  label ints={co.total_label_size} "
        f"(avg {co.total_label_size / g.n:.1f}/vertex)  "
        f"tier widths={co.engine.widths}  device={co.engine.device}"
    )
    return co


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_loop(co, queries: np.ndarray, batch: int, backend: str) -> tuple[float, np.ndarray]:
    """Run the query stream through the engine; returns (seconds, answers).

    Every batch returns its verdicts to the host, so the clock covers the
    device work; a final synchronize guards any work still queued."""
    n_q = queries.shape[0]
    co.serve(queries[:batch], backend=backend)  # warmup (kernel build, allocator)
    device = co.engine.device
    _sync(device)
    t0 = time.perf_counter()
    results = []
    for lo in range(0, n_q, batch):
        results.append(co.serve(queries[lo : lo + batch], backend=backend))
    _sync(device)
    dt = time.perf_counter() - t0
    return dt, np.concatenate(results)


def check_sample(g, queries: np.ndarray, pred: np.ndarray, n_check: int = 200) -> int:
    bad = 0
    for i in range(min(n_check, queries.shape[0])):
        u, v = int(queries[i, 0]), int(queries[i, 1])
        truth = bool(reachable_set(g, u)[v]) or u == v
        bad += truth != bool(pred[i])
    return bad


def run_sweep(args) -> dict:
    """Sweep the backends; returns the run's record (the ``--json-out``
    payload).  Raises ``SystemExit(1)`` on a wrong sampled verdict or a
    moved degradation counter."""
    backends = list(BACKENDS) if args.backend == "all" else [args.backend]
    device = resolve_device(args.device)
    for be in backends:
        try:
            select_backend(be, device)
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(str(e))

    g = make_graph(args)
    co = build(args, g)
    rng = np.random.default_rng(args.seed)
    queries = rng.integers(0, g.n, size=(args.n_queries, 2)).astype(np.int32)

    records = {}
    failed = False
    for be in backends:
        deg0 = dict(co.engine.degradation)
        dt, pred = serve_loop(co, queries, args.batch, be)
        stats = co.engine.last_stats
        mqps = args.n_queries / dt / 1e6
        print(
            f"[{stats['backend']}] served {args.n_queries} queries in {dt:.3f}s "
            f"({mqps:.2f} M qps; {dt / args.n_queries * 1e9:.0f} ns/query)  "
            f"prefiltered {stats['n_prefiltered']}/{stats['n_queries']} of last batch"
        )
        deg = {k: v - deg0.get(k, 0) for k, v in co.engine.degradation.items()}
        if any(deg.values()):
            print(f"[{stats['backend']}] degradation: "
                  f"device->host={deg['device_to_host']} "
                  f"searched={deg['searched']} quarantined={deg['quarantined']}")
        bad = check_sample(g, queries, pred)
        n_check = min(200, args.n_queries)
        print(f"[{stats['backend']}] correctness sample: {n_check - bad}/{n_check} ok")
        failed |= bad > 0 or any(deg.values())
        records[stats["backend"]] = {
            "mqps": round(mqps, 4),
            "ns_per_query": round(dt / args.n_queries * 1e9, 1),
            "bucketing": not args.no_bucketing,
            "sample_errors": bad,
            "degradation": dict(deg),
        }

    payload = {
        "dataset": args.dataset,
        "scale": args.scale,
        "n": g.n,
        "m": g.m,
        "n_queries": args.n_queries,
        "batch": args.batch,
        "label_ints": co.total_label_size,
        "tier_widths": co.engine.widths,
        "torch_device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "backends": records,
    }
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        print(f"wrote {args.json_out}")

    if failed:
        raise SystemExit(1)
    return payload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="citeseer")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--n-queries", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    help="auto|host|dense|kernel, or 'all' to sweep")
    ap.add_argument("--no-bucketing", action="store_true",
                    help="disable length-bucketed micro-batching")
    ap.add_argument("--json-out", default=None,
                    help="write results to this JSON file")
    ap.add_argument("--device", default="cuda",
                    help="where labels live and dense/kernel run (cuda|cpu)")
    return run_sweep(ap.parse_args(argv))


if __name__ == "__main__":
    main()
