"""Observability walkthrough on the PyTorch/CUDA port: a ~5-second faulted
serving run that leaves behind a Perfetto-loadable timeline and a metrics
snapshot.

  PYTHONPATH=src python examples/trace_demo_torch.py              # on the card
  PYTHONPATH=src python examples/trace_demo_torch.py --device cpu

The counterpart of ``examples/trace_demo.py``.  What it does:

  1. builds a small oracle (the build itself is traced: per-wave spans,
     stage seconds accumulate into ``build_stage_seconds_total``),
  2. drives the serving daemon open-loop with injected device stalls and
     failures — enough to expire deadlines, trip the circuit breaker, and
     exercise the host degradation rung,
  3. exports ``trace_demo_torch.json`` (drag it into https://ui.perfetto.dev
     or chrome://tracing) and ``trace_demo_torch_metrics.json``, then prints
     the reconciliation: registry counters == the daemon's own books.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.api import build_oracle
from repro_torch.ft import inject
from repro_torch.graph.generators import random_dag
from repro_torch.obs import metrics, trace
from repro_torch.serve.daemon import DaemonConfig
from repro_torch.serve.openloop import run_open_loop

TRACE_OUT = "trace_demo_torch.json"
METRICS_OUT = "trace_demo_torch_metrics.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engine's labels live (cuda|cpu)")
    device = ap.parse_args(argv).device
    # a clean slate, so the exported snapshot is THIS run and nothing else
    metrics.REGISTRY.reset()
    trace.TRACER.clear()

    g = random_dag(2000, 6000, seed=0)
    print(f"graph: random DAG, n={g.n} m={g.m}")
    # impl="wave": the host engine builder, so the timeline gets per-wave
    # spans and the within-sweep stage seconds (the auto heuristic would
    # pick the reference builder at this size, which has no stage breakdown)
    co = build_oracle(g, impl="wave", device=device)

    # stall dispatch occurrences 3..8 by 120ms (deadlines expire behind the
    # stall) and hard-fail 10..12 (three consecutive: the breaker trips)
    plan = inject.Injector(
        {"serve.device_dispatch": list(range(10, 13))},
        latency={"serve.device_dispatch": (list(range(3, 9)), 0.12)},
    )
    report = run_open_loop(
        co, g, rate_arrivals_per_s=120.0, arrival_batch=64, duration_s=4.0,
        deadline_ms=80.0, config=DaemonConfig(deadline_ms=80.0),
        fault_plan=plan, seed=0, n_truth=200,
    )
    print(f"open-loop on {co.engine.device}: sustained {report['sustained_qps']:.0f} qps, "
          f"shed_rate={report['shed_rate']:.3f}, p99={report['p99_ms']}ms, "
          f"breaker trips={report['breaker']['trips']}")

    trace.TRACER.export_chrome(TRACE_OUT, meta={"demo": "trace_demo_torch"})
    metrics.REGISTRY.export_json(METRICS_OUT)
    n_events = len(trace.TRACER.events)
    print(f"wrote {TRACE_OUT} ({n_events} events) — open it at "
          f"https://ui.perfetto.dev")
    print(f"wrote {METRICS_OUT}")

    # the registry is the substrate under the daemon's counters, not a
    # parallel estimate: show the books reconciling
    with open(METRICS_OUT) as f:
        snap = json.load(f)
    answered = snap["daemon_requests_total"]["values"].get("event=answered", 0)
    shed = sum(snap["daemon_shed_total"]["values"].values())
    faults = sum(snap["faults_injected_total"]["values"].values())
    trips = snap["daemon_breaker_trips_total"]["values"].get("", 0)
    report_shed = sum(report["shed"].values())
    print(f"reconciliation: answered={answered} (report {report['answered']}), "
          f"shed={shed} (report {report_shed}), "
          f"breaker_trips={trips}, faults_fired={faults}")
    stage = snap["build_stage_seconds_total"]["values"]
    top = sorted(stage.items(), key=lambda kv: -kv[1])[:3]
    print("top build stages: "
          + ", ".join(f"{k.split('=', 1)[1]}={v:.3f}s" for k, v in top))
    if answered != report["answered"] or shed != report_shed or report["sample_errors"]:
        raise SystemExit("the registry and the daemon's books disagree, "
                         "or a sampled verdict is wrong")


if __name__ == "__main__":
    main()
