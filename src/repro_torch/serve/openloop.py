"""Open-loop Poisson workload driver for the serving daemon.

Closed-loop drivers (issue the next batch when the last one returns)
self-throttle: an overloaded server just makes the driver slower, and the
throughput number silently degrades to "whatever the server felt like".
This driver is open-loop — arrivals follow a Poisson process whose rate does
NOT react to service times — so overload has to go *somewhere*: the queue,
the shed counters, or the latency tail.  The report makes each explicit:

    sustained_qps   answered queries / duration (capacity actually served)
    shed_rate       queries refused or expired / queries submitted
    p50/p99_ms      latency of ANSWERED (admitted) queries, arrival->answer
    degradation     the engine ladder + breaker counters over the run

The counterpart of ``repro.serve.openloop``: the same arrivals, queries
and report from the same seed.  Used by ``repro_torch.launch.serve --mode
daemon``, ``examples/trace_demo_torch.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.ft import inject
from repro_torch.obs import trace
from repro_torch.obs.state import ON
from repro_torch.serve.daemon import DaemonConfig, ServeDaemon, ShedError


def check_truth(g, queries: np.ndarray, answers: np.ndarray,
                limit: int = 200) -> int:
    """Wrong-answer count vs BFS ground truth on up to ``limit`` queries
    (grouped by source so each distinct u costs one reachable_set)."""
    from repro_torch.graph.reach import reachable_set

    wrong = 0
    reach_cache: Dict[int, np.ndarray] = {}
    for i in range(min(limit, queries.shape[0])):
        u, v = int(queries[i, 0]), int(queries[i, 1])
        if u not in reach_cache:
            reach_cache[u] = reachable_set(g, u)
        truth = bool(reach_cache[u][v]) or u == v
        wrong += truth != bool(answers[i])
    return wrong


async def _drive(daemon: ServeDaemon, arrivals: np.ndarray,
                 queries: List[np.ndarray], deadline_ms: float,
                 answered: list, shed: Dict[str, int]) -> None:
    t0 = time.monotonic()

    async def one(i: int) -> None:
        t_arr = t0 + float(arrivals[i])
        delay = t_arr - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        try:
            ans = await daemon.submit(queries[i], deadline_ms=deadline_ms)
            # latency from the INTENDED arrival instant: loop scheduling
            # jitter is queueing too in a single-process harness
            answered.append((i, ans, time.monotonic() - t_arr))
        except ShedError as e:
            shed[e.reason] = shed.get(e.reason, 0) + queries[i].shape[0]

    await daemon.start()
    await asyncio.gather(*(one(i) for i in range(arrivals.shape[0])))
    await daemon.drain()


def run_open_loop(
    target,
    g,
    *,
    rate_arrivals_per_s: float = 400.0,
    arrival_batch: int = 64,
    duration_s: float = 2.0,
    deadline_ms: float = 150.0,
    config: Optional[DaemonConfig] = None,
    fault_plan: Optional[inject.Injector] = None,
    seed: int = 0,
    n_truth: int = 200,
    budget_ctl=None,
) -> dict:
    """Drive ``target`` (a CondensedOracle, or a dynamic oracle) through an
    open-loop Poisson run; returns the BENCH-row report dict.

    ``fault_plan`` (an ``inject.Injector``, latency rules included) is
    active for the whole run, so device faults hit the daemon's real
    dispatch path — this is how the faulted BENCH row proves the ladder
    holds p99 bounded while shedding instead of collapsing.

    ``budget_ctl`` (a ``serve.budget.BudgetController``) serves the run
    under a memory budget; when it carries a PressureConfig the daemon's
    pressure loop runs live, and the report's ``budget`` section records
    the governor's final state (steps taken, resident bytes)."""
    # deferred: repro_torch.dynamic imports repro_torch.build, which imports
    # repro_torch.serve; a module-level import here would close that cycle
    from repro_torch.dynamic.workload import poisson_times

    cfg = config or DaemonConfig(deadline_ms=deadline_ms)
    rng = np.random.default_rng(seed)
    arrivals = poisson_times(rate_arrivals_per_s, duration_s, seed=seed)
    queries = [rng.integers(0, g.n, size=(arrival_batch, 2)).astype(np.int32)
               for _ in range(arrivals.shape[0])]

    daemon = ServeDaemon(target, cfg, budget_ctl=budget_ctl)
    # warm every rung of the daemon's padded-dispatch ladder before the
    # clock starts (outside any fault plan, so injected occurrences hit the
    # measured run): the first kernel batch builds the kernel and its op,
    # and each larger rung grows the op's staging buffers — first-call
    # costs that would otherwise stall the queue mid-run
    warm_sp = (trace.span("openloop.warmup", cat="openloop",
                          args={"max_batch": cfg.max_batch})
               if ON.enabled else trace.NOOP_SPAN)
    with warm_sp:
        size = 64
        while True:
            wq = rng.integers(0, g.n, size=(min(size, cfg.max_batch), 2)).astype(
                np.int32)
            daemon.engine.query_batch(wq, backend=cfg.backend)
            if size >= cfg.max_batch:
                break
            size *= 2
    daemon.engine.reset_stats()
    answered: list = []
    shed: Dict[str, int] = {}
    drive_sp = (trace.span("openloop.drive", cat="openloop",
                           args={"rate": rate_arrivals_per_s,
                                 "duration_s": duration_s,
                                 "n_arrivals": int(arrivals.shape[0]),
                                 "faulted": fault_plan is not None})
                if ON.enabled else trace.NOOP_SPAN)
    t0 = time.perf_counter()
    with drive_sp:
        if fault_plan is not None:
            with inject.active(fault_plan):
                asyncio.run(_drive(daemon, arrivals, queries, deadline_ms,
                                   answered, shed))
        else:
            asyncio.run(_drive(daemon, arrivals, queries, deadline_ms,
                               answered, shed))
    wall_s = time.perf_counter() - t0

    c = daemon.counters
    n_answered = int(c["answered"])
    # the daemon's counters are authoritative (client-side reasons overlap
    # with shed_expired: the client sees those as ShedError too)
    n_shed = int(c["shed_queue_full"] + c["shed_deadline"]
                 + c["shed_draining"] + c["shed_expired"] + c["shed_killed"])
    lat = np.asarray([la for _, _, la in answered]) if answered else np.zeros(1)
    p50_ms = float(np.quantile(lat, 0.5)) * 1000
    p99_ms = float(np.quantile(lat, 0.99)) * 1000

    sample_errors = 0
    if answered and n_truth > 0:
        rep_sp = (trace.span("openloop.report", cat="openloop",
                             args={"n_truth": n_truth})
                  if ON.enabled else trace.NOOP_SPAN)
        with rep_sp:
            aq = np.concatenate([queries[i] for i, _, _ in answered], axis=0)
            aa = np.concatenate([a for _, a, _ in answered], axis=0)
            pick = rng.choice(aq.shape[0], size=min(n_truth, aq.shape[0]),
                              replace=False)
            sample_errors = check_truth(g, aq[pick], aa[pick], limit=n_truth)

    health = daemon.health()
    return {
        "rate_arrivals_per_s": rate_arrivals_per_s,
        "arrival_batch": int(arrival_batch),
        "offered_qps": round(rate_arrivals_per_s * arrival_batch),
        "duration_s": duration_s,
        "deadline_ms": deadline_ms,
        "n_arrivals": int(arrivals.shape[0]),
        "submitted": int(c["submitted"]),
        "answered": n_answered,
        "sustained_qps": round(n_answered / max(wall_s, 1e-9)),
        "shed": {k[len("shed_"):]: int(v) for k, v in c.items()
                 if k.startswith("shed_") and v},
        "shed_rate": round(n_shed / max(int(c["submitted"]), 1), 4),
        "p50_ms": round(p50_ms, 2),
        "p99_ms": round(p99_ms, 2),
        "p99_within_deadline": bool(p99_ms <= deadline_ms),
        "breaker": {"trips": daemon.breaker.trips,
                    "final_state": daemon.breaker.state},
        "batches": int(c["batches"]),
        "device_batches": int(c["device_batches"]),
        "breaker_host_batches": int(c["breaker_host_batches"]),
        "degradation": health["engine"]["degradation"],
        "budget": health["budget"],
        "faults": (None if fault_plan is None else
                   {"failed": list(fault_plan.fired),
                    "stalled": list(fault_plan.stalled)}),
        "sample_errors": int(sample_errors),
    }
