"""Where a dynamic oracle's publish holds the interpreter lock.

    PYTHONPATH=src python tools/publish_lock_probe.py --scale 0.1 --device cpu
    PYTHONPATH=src python tools/publish_lock_probe.py --scale 1.0   # on a card
    PYTHONPATH=src python tools/publish_lock_probe.py --scale 1.0 --rows-per-pass 0

Builds a ``repro_torch.dynamic.DurableDynamicOracle`` of the citeseer
analogue (the cyclic collector paused while it builds and the heap frozen
after, as ``chip_smoke.py`` phase 4h does), then applies and publishes
``--rounds`` batches of ``--updates`` DAG-preserving updates.  Each publish
runs in a worker thread, as the serving daemon runs it, while the main
thread wakes every millisecond.  A wake-up later than ``--gap-ms`` is a
stretch in which the publish thread held the interpreter lock (a serving
thread would have waited as long); each is booked with where the publish
thread stood when the main thread got the lock back (its three innermost
frames), which is just past the call that held it.

``--rows-per-pass`` sets ``repro_torch.persist.blocks.ROWS_PER_PASS``, the
rows one C-level pass of the snapshot takes at a time (0: every row in one
pass).  Prints one JSON line a publish (its seconds, the stretches over
``--gap-ms``, the longest five with their places, the collector's passes
by generation) and one summary line.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import threading
import time


def _where(frame, depth: int = 3) -> list:
    out = []
    while frame is not None and len(out) < depth:
        out.append(f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno}")
        frame = frame.f_back
    return out


def probe_publish(dyn, gap_s: float) -> dict:
    """Publish ``dyn`` in a worker thread; book the main thread's late
    wake-ups and the collector's passes meanwhile."""
    passes = []

    def on_gc(phase, info):
        if phase == "start":
            passes.append(info["generation"])

    ident = {}

    def publish():
        ident["t"] = threading.get_ident()
        dyn.publish()

    worker = threading.Thread(target=publish)
    gc.callbacks.append(on_gc)
    try:
        t0 = last = time.perf_counter()
        worker.start()
        gaps = []
        while worker.is_alive():
            time.sleep(0.001)
            now = time.perf_counter()
            if now - last > gap_s:
                gaps.append((now - last, _where(sys._current_frames().get(ident.get("t")))))
            last = now
        worker.join()
        seconds = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    gaps.sort(key=lambda g: -g[0])
    return {"seconds": seconds, "gaps_over": len(gaps),
            "held_ms": 1e3 * sum(g for g, _ in gaps),
            "longest": [{"ms": 1e3 * g, "where": w} for g, w in gaps[:5]],
            "gc_passes": {f"gen{k}": passes.count(k) for k in range(3)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="citeseer")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--updates", type=int, default=100)
    ap.add_argument("--gap-ms", type=float, default=5.0)
    ap.add_argument("--rows-per-pass", type=int, default=None,
                    help="rows a snapshot pass takes (default: persist.blocks'; 0: all)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.dynamic import DurableDynamicOracle, generate_trace
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.persist import blocks

    if args.rows_per_pass is not None:
        blocks.ROWS_PER_PASS = args.rows_per_pass or (1 << 62)
    g = paper_dataset_analogue(args.dataset, scale=args.scale)
    trace = generate_trace(g, rounds=args.rounds, updates_per_round=args.updates,
                           queries_per_round=1, insert_frac=0.6, dag_preserving=True,
                           seed=args.seed)
    batches = [op.batch for op in trace if op.kind == "update"]
    head = {"dataset": args.dataset, "scale": args.scale, "n": g.n, "device": args.device,
            "rows_per_pass": blocks.ROWS_PER_PASS if args.rows_per_pass != 0 else "all",
            "gap_ms": args.gap_ms,
            "switch_interval_ms": 1e3 * sys.getswitchinterval()}
    with tempfile.TemporaryDirectory(prefix="publish_lock_probe_") as tmp:
        t0 = time.perf_counter()
        gc.disable()
        try:
            dyn = DurableDynamicOracle(g, state_dir=tmp, device=args.device)
        finally:
            gc.freeze()
            gc.enable()
        head["construct_seconds"] = time.perf_counter() - t0
        rows = []
        for r, batch in enumerate(batches):
            dyn.apply(batch)
            rec = {"round": r, **probe_publish(dyn, args.gap_ms / 1e3)}
            rows.append(rec)
            print(json.dumps({**head, **rec}), flush=True)
        del dyn
        gc.unfreeze()
    print(json.dumps({**head, "summary": True,
                      "publish_seconds": [r["seconds"] for r in rows],
                      "longest_ms": max((r["longest"][0]["ms"] for r in rows if r["longest"]),
                                        default=0.0),
                      "held_ms": [r["held_ms"] for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
