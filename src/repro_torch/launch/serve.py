"""Oracle serving driver of the port: closed-loop backend sweeps and the
open-loop serving daemon.

  python -m repro_torch.launch.serve --dataset citeseer --scale 0.02 \
      --n-queries 100000 --batch 4096 --backend all

Open-loop daemon (admission control + deadline shedding + circuit breaker;
SIGTERM drains gracefully):

  python -m repro_torch.launch.serve --mode daemon --rate 400 \
      --arrival-batch 64 --duration 3 --deadline-ms 150

Builds the oracle on ``--device`` (default ``cuda``; ``--device cpu`` runs
the dense/kernel backends' plain torch paths on the CPU), streams uniform
random queries through each backend, and checks a BFS correctness sample.
Exits non-zero when a sampled verdict is wrong or a degradation counter
moved (a clean run degrades nothing but the rows a ``--load-mode
quarantine`` cold start quarantined, and ``--inject-device-failure K``
only the device -> host rung).
``--checkpoint-dir`` makes the build crash-safe (the host batched engines'
wave-granular checkpoints; a re-run resumes).

Lifecycle, in ``repro``'s order: ``--snapshot-dir`` cold-starts from a
``persist.save_oracle`` snapshot when the directory exists
(``--load-mode quarantine`` arms the degradation ladder instead of refusing
a corrupt snapshot) and saves one after a fresh build.  ``--state-dir``
serves a ``DurableDynamicOracle``, recovering snapshot + WAL when the
directory holds a snapshot (either package's) and starting one there when
it does not.
``--inject-device-failure`` / ``--inject-device-latency`` aim deterministic
faults at the dispatch path; ``--budget-mb`` / ``--pressure-watermark``
serve the daemon under a memory budget.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.api import build_oracle, oracle_from_snapshot
from repro_torch.device import resolve_device
from repro_torch.ft import inject
from repro_torch.graph.generators import paper_dataset_analogue, random_dag
from repro_torch.graph.reach import reachable_set
from repro_torch.obs import metrics, trace
from repro_torch.serve.daemon import DaemonConfig, ServeDaemon
from repro_torch.serve.engine import select_backend
from repro_torch.serve.openloop import run_open_loop

# the backends ``--backend all`` sweeps: those of one device (the sharded
# ones need a mesh of ranks), as ``repro.launch.serve.HOST_BACKENDS``
HOST_BACKENDS = ("host", "dense", "kernel")


def make_graph(args):
    g = (
        paper_dataset_analogue(args.dataset, scale=args.scale)
        if args.dataset != "random"
        else random_dag(20000, 50000, seed=args.seed)
    )
    print(f"graph: n={g.n} m={g.m}")
    return g


def build(args, g):
    ckpt_kwargs = {}
    if args.checkpoint_dir:
        # crash-safe build: wave-granular checkpoints; a re-run with the same
        # flags resumes from the latest complete one and finishes byte-identical
        ckpt_kwargs = dict(checkpoint_dir=args.checkpoint_dir,
                           checkpoint_every=args.checkpoint_every)
    t0 = time.perf_counter()
    co = build_oracle(g, bucketing=not args.no_bucketing, device=args.device,
                      **ckpt_kwargs)
    t_build = time.perf_counter() - t0
    print(
        f"DL build: {t_build:.2f}s  label ints={co.total_label_size} "
        f"(avg {co.total_label_size / g.n:.1f}/vertex)  "
        f"tier widths={co.engine.widths}  device={co.engine.device}"
    )
    ck = co.oracle.build_stats.get("checkpoint")
    if ck is not None:
        print(f"checkpoints: resumed_from={ck['resumed_from']} "
              f"written={ck['written']} -> {args.checkpoint_dir}")
    return co


def build_target(args, g):
    """Resolve the serving target through the lifecycle ladder:
    durable-dynamic recovery > snapshot cold start > fresh build (saving a
    snapshot when ``--snapshot-dir`` is given).  Returns (target, lifecycle
    record); the target is a ``DurableDynamicOracle`` with ``--state-dir``,
    else a ``CondensedOracle``."""
    if args.state_dir:
        from repro_torch.dynamic import DurableDynamicOracle

        has_state = os.path.isdir(args.state_dir) and any(
            name.startswith("snap_") for name in os.listdir(args.state_dir))
        if has_state:
            t0 = time.perf_counter()
            dyn = DurableDynamicOracle.recover(
                args.state_dir, bucketing=not args.no_bucketing, device=args.device)
            seconds = time.perf_counter() - t0
            print(f"recovered durable oracle from {args.state_dir} in "
                  f"{seconds:.2f}s (epoch={dyn.epoch}, "
                  f"wal records replayed={dyn.recovered_records})")
            return dyn, {"recover_seconds": seconds, "epoch": dyn.epoch,
                         "wal_records_replayed": dyn.recovered_records}
        t0 = time.perf_counter()
        dyn = DurableDynamicOracle(g, state_dir=args.state_dir,
                                   bucketing=not args.no_bucketing, device=args.device)
        print(f"durable oracle initialized at {args.state_dir}")
        return dyn, {"initialized_state_dir": args.state_dir,
                     "init_seconds": time.perf_counter() - t0}
    if args.snapshot_dir and os.path.isdir(args.snapshot_dir):
        t0 = time.perf_counter()
        co = oracle_from_snapshot(g, args.snapshot_dir, mode=args.load_mode,
                                  bucketing=not args.no_bucketing, device=args.device)
        seconds = time.perf_counter() - t0
        nq = co.engine.stats()["n_quarantined"]
        print(f"cold start from snapshot {args.snapshot_dir} in {seconds:.2f}s"
              + (f" ({nq} rows quarantined)" if nq else ""))
        return co, {"cold_start_seconds": seconds, "n_quarantined": nq}
    co = build(args, g)
    if args.snapshot_dir:
        from repro_torch.persist import save_oracle

        save_oracle(args.snapshot_dir, co.oracle)
        print(f"saved index snapshot -> {args.snapshot_dir}")
        return co, {"saved_snapshot": args.snapshot_dir}
    return co, {}


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
    moved degradation counter (other than the quarantine rung of a
    quarantine-mode cold start, and the device -> host rung that
    ``--inject-device-failure`` aims at)."""
    backends = list(HOST_BACKENDS) if args.backend == "all" else [args.backend]
    device = resolve_device(args.device)
    for be in backends:
        try:
            select_backend(be, device)
        except ValueError as e:
            raise SystemExit(str(e))

    g = make_graph(args)
    co, lifecycle = build_target(args, g)
    # a quarantine-mode cold start sends the quarantined rows' queries to
    # exact search: those two counters may move, together, and no other
    quarantine_rung = co.engine.stats()["n_quarantined"] > 0
    rng = np.random.default_rng(args.seed)
    queries = rng.integers(0, g.n, size=(args.n_queries, 2)).astype(np.int32)

    records = {}
    failed = False
    for be in backends:
        deg0 = dict(co.engine.degradation)
        if args.inject_device_failure is not None:
            # fresh plan per backend: occurrence counters live on the injector
            plan = inject.Injector(
                {"serve.device_dispatch": args.inject_device_failure})
            with inject.active(plan):
                dt, pred = serve_loop(co, queries, args.batch, be)
        else:
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
        allowed = set()
        if quarantine_rung:
            allowed |= {"quarantined", "searched"}
        if args.inject_device_failure is not None:
            allowed.add("device_to_host")
        unexpected = {k: v for k, v in deg.items() if v and k not in allowed}
        failed |= bad > 0 or bool(unexpected) or deg["searched"] != deg["quarantined"]
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
        "lifecycle": lifecycle,
        **_device_record(device),
        "backends": records,
    }
    _write_json(args, payload)
    if failed:
        raise SystemExit(1)
    return payload


def _device_record(device: torch.device) -> dict:
    return {"torch_device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")}


def _write_json(args, payload: dict) -> None:
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        print(f"wrote {args.json_out}")


# ----------------------------------------------------------- open-loop daemon


def _parse_occurrences(spec: str):
    """'3' -> [3];  '2-5' -> [2,3,4,5];  '1,4' -> [1,4]."""
    out = []
    for part in str(spec).split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


def fault_plan_from_args(args):
    """CLI fault flags -> one deterministic inject.Injector (or None)."""
    rules = {}
    latency = {}
    if args.inject_device_failure is not None:
        rules["serve.device_dispatch"] = _parse_occurrences(
            args.inject_device_failure)
    if args.inject_device_latency:
        occ, ms = args.inject_device_latency.rsplit(":", 1)
        latency["serve.device_dispatch"] = (
            _parse_occurrences(occ), float(ms) / 1000.0)
    if not rules and not latency:
        return None
    return inject.Injector(rules, latency=latency)


def _dump_obs(args) -> None:
    """Export the trace ring / metrics snapshot to the CLI out-files.

    Runs on every exit path (normal completion, SIGTERM drain, faulted
    abort), so a misbehaving run still leaves its timeline behind."""
    if args.trace_out:
        trace.export_chrome(args.trace_out,
                            meta={"mode": args.mode, "dataset": args.dataset})
        print(f"wrote trace -> {args.trace_out}")
    if args.metrics_out:
        metrics.export_json(args.metrics_out)
        print(f"wrote metrics -> {args.metrics_out}")


def budget_ctl_from_args(args, target):
    """CLI budget flags -> a BudgetController (or None).

    ``--budget-mb`` serves under a hard label-byte budget from the start;
    ``--pressure-watermark`` (MiB of resident label bytes) arms the live
    pressure loop — with no initial budget, the daemon serves the full
    store until the signal crosses the watermark, then steps down."""
    if args.budget_mb is None and args.pressure_watermark is None:
        return None
    from repro_torch.serve.budget import BudgetController, PressureConfig

    engine = getattr(target, "engine", target)
    pressure = None
    if args.pressure_watermark is not None:
        pressure = PressureConfig(
            watermark_bytes=int(args.pressure_watermark * (1 << 20)))
    ctl = BudgetController(
        engine,
        budget_bytes=(None if args.budget_mb is None
                      else int(args.budget_mb * (1 << 20))),
        pressure=pressure,
    )
    snap = ctl.snapshot()
    print(f"budget: {snap['budget_bytes'] or 'none'} bytes over a "
          f"{snap['full_bytes']}-byte full store "
          f"(resident {snap['resident_bytes']}, rank_cut={snap['rank_cut']}"
          + (f", watermark {pressure.watermark_bytes}" if pressure else "")
          + ")")
    return ctl


def run_daemon(args) -> dict:
    """One open-loop run of the daemon over the built (or cold-started)
    oracle; returns the run's record (the ``--json-out`` payload).  Raises
    ``SystemExit(1)`` when a sampled verdict is wrong."""
    device = resolve_device(args.device)
    g = make_graph(args)
    target, lifecycle = build_target(args, g)
    budget_ctl = budget_ctl_from_args(args, target)
    cfg = DaemonConfig(
        batch_window_ms=args.batch_window_ms,
        max_batch=args.max_batch,
        queue_limit=args.queue_limit,
        deadline_ms=args.deadline_ms,
        backend=None if args.backend in ("auto", "all") else args.backend,
        breaker_failures=args.breaker_failures,
        breaker_slo_ms=args.breaker_slo_ms,
    )

    # SIGTERM/SIGINT -> graceful drain: admission starts shedding
    # ("draining"), already-admitted requests are served, then the loop
    # stops.  The handler only flips state; the drain in run_open_loop's
    # driver does the rest.
    daemon_box = {}

    def _drain_handler(signum, frame):
        d = daemon_box.get("daemon")
        if d is not None and d.state == "ready":
            print(f"signal {signum}: draining (new arrivals shed)")
            d.state = "draining"

    old_term = signal.signal(signal.SIGTERM, _drain_handler)
    old_int = signal.signal(signal.SIGINT, _drain_handler)

    # run_open_loop creates the daemon internally; intercept its __init__ so
    # the signal handler can reach it
    orig_init = ServeDaemon.__init__

    def _capturing_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        daemon_box["daemon"] = self

    ServeDaemon.__init__ = _capturing_init
    # zero the registry and trace ring at daemon start: the exported metrics
    # snapshot then reconciles EXACTLY with this run's daemon counters
    # (build-time metrics would otherwise leak into the serving numbers)
    metrics.REGISTRY.reset()
    trace.TRACER.clear()
    stop_dump = threading.Event()
    dump_thread = None
    if args.metrics_out and args.metrics_interval > 0:
        def _periodic() -> None:
            while not stop_dump.wait(args.metrics_interval):
                metrics.export_json(args.metrics_out)

        dump_thread = threading.Thread(target=_periodic, daemon=True)
        dump_thread.start()
    try:
        report = run_open_loop(
            target, g,
            rate_arrivals_per_s=args.rate,
            arrival_batch=args.arrival_batch,
            duration_s=args.duration,
            deadline_ms=args.deadline_ms,
            config=cfg,
            fault_plan=fault_plan_from_args(args),
            seed=args.seed,
            budget_ctl=budget_ctl,
        )
    finally:
        ServeDaemon.__init__ = orig_init
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        stop_dump.set()
        if dump_thread is not None:
            dump_thread.join(timeout=2.0)
        _dump_obs(args)

    daemon = daemon_box.get("daemon")
    health = daemon.health() if daemon is not None else {}
    print(f"daemon: answered {report['answered']} of {report['submitted']} "
          f"submitted ({report['sustained_qps']} qps sustained, "
          f"offered {report['offered_qps']})")
    print(f"daemon: shed_rate={report['shed_rate']:.3f} {report['shed']}  "
          f"p50={report['p50_ms']:.1f}ms p99={report['p99_ms']:.1f}ms "
          f"(deadline {report['deadline_ms']:.0f}ms, "
          f"within={report['p99_within_deadline']})")
    print(f"daemon: breaker trips={report['breaker']['trips']} "
          f"degradation={report['degradation']}  "
          f"sample_errors={report['sample_errors']}")
    if report.get("budget"):
        b = report["budget"]
        print(f"daemon: budget resident={b['resident_bytes']}/{b['full_bytes']} "
              f"bytes rank_cut={b['rank_cut']} steps_down={b['steps_down']} "
              f"steps_up={b['steps_up']} retruncations={b['retruncations']}")
    payload = {"dataset": args.dataset, "scale": args.scale,
               "n": g.n, "m": g.m, "mode": "daemon", "lifecycle": lifecycle,
               **_device_record(device), "report": report, "health": health}
    _write_json(args, payload)
    if report["sample_errors"]:
        raise SystemExit(1)
    return payload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="sweep", choices=["sweep", "daemon"],
                    help="sweep = closed-loop backend sweep; daemon = "
                         "open-loop admission-controlled serving")
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
    # lifecycle
    ap.add_argument("--checkpoint-dir", default=None,
                    help="wave-granular build checkpoints; re-running with the "
                         "same flags resumes from the latest complete one")
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    help="schedule boundaries between checkpoints")
    ap.add_argument("--snapshot-dir", default=None,
                    help="cold-start from this persist.save_oracle snapshot "
                         "when it exists; save one after a fresh build")
    ap.add_argument("--load-mode", default="strict", choices=["strict", "quarantine"],
                    help="strict: refuse a corrupt snapshot; quarantine: "
                         "serve around corrupt rows via the degradation ladder")
    ap.add_argument("--state-dir", default=None,
                    help="serve a DurableDynamicOracle out of this WAL+snapshot "
                         "dir (recovers when non-empty)")
    # daemon knobs
    ap.add_argument("--rate", type=float, default=400.0,
                    help="daemon mode: Poisson arrival rate (arrivals/sec)")
    ap.add_argument("--arrival-batch", type=int, default=64,
                    help="queries per arrival")
    ap.add_argument("--duration", type=float, default=3.0,
                    help="daemon mode: open-loop run seconds")
    ap.add_argument("--deadline-ms", type=float, default=150.0)
    ap.add_argument("--queue-limit", type=int, default=8192)
    ap.add_argument("--max-batch", type=int, default=4096)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--breaker-failures", type=int, default=3)
    ap.add_argument("--breaker-slo-ms", type=float, default=None)
    # memory budget
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="daemon mode: serve under this label-byte budget "
                         "(MiB) via rank-prefix truncation; verdicts the cut "
                         "labels cannot prove route to exact online search")
    ap.add_argument("--pressure-watermark", type=float, default=None,
                    help="daemon mode: arm the live memory-pressure loop — "
                         "step the budget down while resident label bytes "
                         "exceed this watermark (MiB), back up with hysteresis")
    # faults
    ap.add_argument("--inject-device-failure", default=None, metavar="OCCS",
                    help="fault the given device-dispatch occurrences "
                         "('4' / '2-5' / '1,7'); sweep mode takes a single int")
    ap.add_argument("--inject-device-latency", default=None, metavar="OCCS:MS",
                    help="daemon mode: stall the given device-dispatch "
                         "occurrences by MS milliseconds (e.g. '2-6:60')")
    # observability
    ap.add_argument("--trace-out", default=None,
                    help="daemon mode: write the run's Chrome-trace timeline "
                         "here at exit (load in ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None,
                    help="daemon mode: write the metrics-registry snapshot "
                         "JSON here at exit")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    help="also rewrite --metrics-out every N seconds while "
                         "the daemon runs")
    ap.add_argument("--no-obs", action="store_true",
                    help="disable the observability layer entirely "
                         "(obs.disable(); the overhead-guard baseline)")
    args = ap.parse_args(argv)

    if args.no_obs:
        obs.disable()
    if args.mode == "daemon":
        return run_daemon(args)
    if args.inject_device_failure is not None:
        # sweep mode keeps the JAX driver's single-occurrence semantics
        args.inject_device_failure = int(args.inject_device_failure)
    return run_sweep(args)


if __name__ == "__main__":
    main()
