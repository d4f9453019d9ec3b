"""Overload-safe serving daemon: admission control, batching, degradation.

The QueryEngine answers batches; this module is the *system* around it that
keeps answering under open-loop load, device trouble, and concurrent
dynamic publishes.  One asyncio process, one dispatch at a time:

    submit() -> admission control -> bounded ingress queue
             -> collect-for-a-few-ms batching (one padded device dispatch
                per tick; tier bucketing via the engine's planner)
             -> circuit breaker (device SLO) -> engine degradation ladder
             -> per-request futures

Robustness posture (FERRARI-style budgeted serving, applied to latency):

  * **bounded ingress** — the queue admits at most ``queue_limit`` queries;
    past that, arrivals shed with ``queue_full`` instead of growing an
    unbounded backlog,
  * **deadline-aware shedding** — every request carries a deadline; at
    admission the daemon estimates queue depth / measured service rate and
    sheds requests that could not finish in budget ("deadline"), and at
    dispatch it sheds requests whose budget already expired ("expired") —
    serving a dead request only delays live ones,
  * **circuit breaker** — consecutive device-dispatch failures or
    latency-SLO misses trip the breaker: batches route straight to the host
    merge rung (retry-with-downgrade, never retry-same), and the device is
    re-probed after an exponential backoff.  Breaker state and the engine's
    ``degradation`` counters surface in ``health()``,
  * **pinned-epoch routing** — while a dynamic publish is in flight,
    batches serve from the ``LabelEpoch`` snapshot pinned at publish start,
    so no batch ever observes a half-refreshed engine and publishes never
    stall serving,
  * **graceful drain** — ``drain()`` (wired to SIGTERM in the CLI) stops
    admission, serves everything already admitted, then stops; ``kill()``
    is the abrupt variant the chaos suite uses.

Every rung stays exact: overload and faults shed or degrade, they never
produce a wrong verdict.

The counterpart of ``repro.serve.daemon``, with the same counters, metric
families and breaker.  On the card a device dispatch is one
``ops.ServeBatch`` call (K1's batch form) issued from the executor thread on
the engine's device and that device's current stream.  The breaker's
failure signal is the engine's ``device_to_host`` (taken only for an
injected ``ft.inject.SimulatedFailure``; a real kernel failure raises
through the request futures) and ``deadline_to_host`` rungs, or an SLO miss.
Pinned-epoch routing serves any target with ``snapshot`` + ``publish``, the
port's ``dynamic.DynamicOracle`` among them; on the card a pinned batch is
one launch of K1's tier form (``LabelEpoch.query_batch``), issued from the
executor thread on the epoch's device and that device's current stream.  Two
differences from ``repro``: the pinned epoch's device -> host rung, too, is
taken only for ``SimulatedFailure`` (``repro`` takes it for any exception);
and a pressure tick that ``drain``/``kill`` cancels while its thread runs
is still counted, so the books always match the controller's.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.ft import inject
from repro_torch.obs import metrics, trace
from repro_torch.obs.state import ON


class ShedError(RuntimeError):
    """A request the daemon refused (admission) or dropped (expired).

    ``reason`` is one of: queue_full, deadline, draining, expired, killed.
    Sheds are explicit backpressure — the client is told immediately, and
    the request never consumes service capacity."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"shed[{reason}]" + (f": {detail}" if detail else ""))
        self.reason = reason


@dataclasses.dataclass
class DaemonConfig:
    """Knobs for the admission/batching loop and the breaker."""

    batch_window_ms: float = 2.0     # collect arrivals for this long per tick
    max_batch: int = 4096            # queries per padded device dispatch
    queue_limit: int = 8192          # bounded ingress (queries, not arrivals)
    deadline_ms: float = 100.0       # default per-request latency budget
    backend: Optional[str] = None    # None = the engine's default backend
    breaker_failures: int = 3        # consecutive bad dispatches that trip it
    breaker_slo_ms: Optional[float] = None   # default: deadline_ms / 2
    breaker_backoff_ms: float = 100.0        # first re-probe delay
    breaker_backoff_max_ms: float = 5000.0
    shed_headroom: float = 1.0       # admit while est. wait < headroom * budget

    @property
    def slo_s(self) -> float:
        slo = (self.deadline_ms / 2.0 if self.breaker_slo_ms is None
               else self.breaker_slo_ms)
        return slo / 1000.0


@dataclasses.dataclass
class _Request:
    queries: np.ndarray
    deadline: float            # absolute time.monotonic()
    t_submit: float
    future: asyncio.Future
    trace_id: int = 0          # obs.trace id carried admission -> completion


class CircuitBreaker:
    """Consecutive-failure / latency-SLO breaker over the device backend.

    closed -> (failures >= threshold) -> open -> (backoff elapses) ->
    half_open -> one probe batch -> closed on success, open (doubled
    backoff) on failure.  "Failure" is either a device dispatch the engine
    had to downgrade (its ladder already re-served the batch on the host —
    retry-with-downgrade, so no answers were lost) or a dispatch that blew
    the latency SLO."""

    def __init__(self, failures: int, backoff_s: float, backoff_max_s: float):
        self.threshold = max(int(failures), 1)
        self.backoff0 = float(backoff_s)
        self.backoff_max = float(backoff_max_s)
        self.state = "closed"
        self.consecutive = 0
        self.trips = 0
        self.backoff = self.backoff0
        self.open_until = 0.0

    def allow_device(self, now: float) -> bool:
        """May the next dispatch try the device?  Flips open -> half_open
        when the backoff has elapsed (the probe)."""
        if self.state == "closed":
            return True
        if self.state == "open" and now >= self.open_until:
            self.state = "half_open"
        return self.state == "half_open"

    def record(self, ok: bool, now: float) -> None:
        if ok:
            if self.state == "half_open":
                self.backoff = self.backoff0   # healthy probe: full reset
            self.state = "closed"
            self.consecutive = 0
            return
        self.consecutive += 1
        if self.state == "half_open":
            # failed probe: reopen immediately with a doubled backoff
            self.backoff = min(self.backoff * 2, self.backoff_max)
            self._trip(now)
        elif self.consecutive >= self.threshold:
            self._trip(now)

    def _trip(self, now: float) -> None:
        self.state = "open"
        self.trips += 1
        self.open_until = now + self.backoff
        self.consecutive = 0
        _BREAKER_TRIPS.inc()
        if ON.enabled:
            trace.event("breaker_open", cat="daemon", trips=self.trips,
                        backoff_ms=round(self.backoff * 1000, 1))

    def snapshot(self, now: float) -> dict:
        return {
            "state": self.state,
            "trips": self.trips,
            "consecutive_failures": self.consecutive,
            "backoff_ms": round(self.backoff * 1000, 1),
            "reprobe_in_ms": round(max(self.open_until - now, 0.0) * 1000, 1),
        }


_ZERO_COUNTERS = {
    "submitted": 0, "admitted": 0, "answered": 0,
    "shed_queue_full": 0, "shed_deadline": 0, "shed_draining": 0,
    "shed_expired": 0, "shed_killed": 0,
    "batches": 0, "device_batches": 0, "breaker_host_batches": 0,
    "pinned_epoch_batches": 0, "pinned_device_to_host": 0,
    "publishes": 0,
    "budget_steps_down": 0, "budget_steps_up": 0,
}

# Registry-backed mirrors of the per-daemon counter dict: every counter key
# maps to a bound child of a labeled family, resolved ONCE here so the hot
# path pays a dict lookup + one add.  The dict on the daemon instance stays
# the per-instance view (openloop reports read it); the registry is the
# process-global surface health()/--metrics-out export.
_REQUESTS = metrics.counter(
    "daemon_requests_total", "queries through admission, by outcome stage",
    labelnames=("event",))
_SHED = metrics.counter(
    "daemon_shed_total", "queries shed, by reason", labelnames=("reason",))
_BATCHES = metrics.counter(
    "daemon_batches_total", "dispatched batches, by serving rung",
    labelnames=("rung",))
_PUBLISHES = metrics.counter(
    "daemon_publishes_total", "dynamic epochs published through the daemon")
_BREAKER_TRIPS = metrics.counter(
    "daemon_breaker_trips_total", "circuit-breaker closed/half_open -> open flips")
_QUEUE_DEPTH = metrics.gauge(
    "daemon_queue_depth", "admitted queries waiting for a dispatch tick")
_REQ_LATENCY = metrics.histogram(
    "daemon_request_latency_ms", "answered requests, arrival -> future resolve")
_DISPATCH_MS = metrics.histogram(
    "daemon_dispatch_ms", "padded-batch dispatch wall time (worker thread)")
_BUDGET_STEPS = metrics.counter(
    "daemon_budget_steps_total",
    "pressure-loop budget steps taken between dispatch ticks",
    labelnames=("direction",))

_COUNTER_METRICS = {
    "submitted": _REQUESTS.labels(event="submitted"),
    "admitted": _REQUESTS.labels(event="admitted"),
    "answered": _REQUESTS.labels(event="answered"),
    "shed_queue_full": _SHED.labels(reason="queue_full"),
    "shed_deadline": _SHED.labels(reason="deadline"),
    "shed_draining": _SHED.labels(reason="draining"),
    "shed_expired": _SHED.labels(reason="expired"),
    "shed_killed": _SHED.labels(reason="killed"),
    "batches": _BATCHES.labels(rung="all"),
    "device_batches": _BATCHES.labels(rung="device"),
    "breaker_host_batches": _BATCHES.labels(rung="breaker_host"),
    "pinned_epoch_batches": _BATCHES.labels(rung="pinned_epoch"),
    "pinned_device_to_host": _BATCHES.labels(rung="pinned_host"),
    "publishes": _PUBLISHES.labels(),
    "budget_steps_down": _BUDGET_STEPS.labels(direction="down"),
    "budget_steps_up": _BUDGET_STEPS.labels(direction="up"),
}


class ServeDaemon:
    """Single-process async serving daemon over one oracle.

    ``target`` duck-types three shapes:

      * a ``repro_torch.core.api.CondensedOracle`` (static labels),
      * a dynamic oracle with ``snapshot``/``publish``/``apply``
        (``publish`` + pinned-epoch routing become live),
      * a bare ``QueryEngine`` (tests).

    The engine dispatch runs in a worker thread (``run_in_executor``) so
    the event loop keeps admitting and timestamping arrivals while a padded
    batch is on the device — but there is only ever ONE dispatch in flight:
    the batch loop awaits it before collecting the next tick.
    """

    def __init__(self, target, config: Optional[DaemonConfig] = None,
                 budget_ctl=None):
        self.target = target
        self.engine = getattr(target, "engine", target)
        self.cfg = config or DaemonConfig()
        # optional serve.budget.BudgetController: when it carries a
        # PressureConfig, start() runs its tick between dispatch ticks —
        # re-truncations happen under _engine_lock, in the gaps between
        # batches, so a budget step can never drop an in-flight batch
        self.budget_ctl = budget_ctl
        self._dynamic = hasattr(target, "snapshot") and hasattr(target, "publish")
        self.state = "starting"
        self.counters: Dict[str, int] = dict(_ZERO_COUNTERS)
        self.latencies = collections.deque(maxlen=8192)  # answered, seconds
        self.breaker = CircuitBreaker(
            self.cfg.breaker_failures,
            self.cfg.breaker_backoff_ms / 1000.0,
            self.cfg.breaker_backoff_max_ms / 1000.0,
        )
        self._queue: asyncio.Queue = asyncio.Queue()
        self._queued = 0          # admitted queries not yet dispatched
        self._inflight = 0        # queries inside the current dispatch
        self._rate_qps: Optional[float] = None   # EWMA of service rate
        self._publishing = False
        self._publish_pin = None  # LabelEpoch served while a publish runs
        # serializes engine-path dispatches against engine.refresh: a batch
        # that entered the engine just before a publish flipped the pin flag
        # must finish before the publish may swap label arrays under it
        self._engine_lock = threading.Lock()
        self._loop_task: Optional[asyncio.Task] = None
        self._pressure_task: Optional[asyncio.Task] = None

    def _count(self, key: str, n: int = 1) -> None:
        """Bump the per-instance counter AND its registry mirror, so the
        daemon report and ``metrics.snapshot()`` reconcile exactly."""
        self.counters[key] += n
        _COUNTER_METRICS[key].inc(n)

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        if self._loop_task is not None:
            return
        self._loop_task = asyncio.ensure_future(self._run())
        if self.budget_ctl is not None and self.budget_ctl.pressure is not None:
            self._pressure_task = asyncio.ensure_future(self._pressure_loop())
        self.state = "ready"

    async def drain(self) -> dict:
        """Graceful shutdown: stop admitting, serve the admitted backlog,
        stop the loop.  Returns the final counters."""
        self.state = "draining"
        while self._queued > 0 or self._inflight > 0:
            await asyncio.sleep(self.cfg.batch_window_ms / 1000.0)
        await self._stop_loop()
        self.state = "stopped"
        return dict(self.counters)

    async def kill(self) -> None:
        """Abrupt stop (the chaos suite's mid-serve crash): the batch loop
        is cancelled mid-dispatch, and both queued and in-flight requests
        get ``shed[killed]`` — nothing drains."""
        await self._stop_pressure()
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
            self._loop_task = None
        while not self._queue.empty():
            req = self._queue.get_nowait()
            if req is not None and not req.future.done():
                req.future.set_exception(ShedError("killed"))
                self._count("shed_killed", req.queries.shape[0])
                if ON.enabled:
                    trace.event("shed", cat="request", reason="killed",
                                trace_id=req.trace_id)
        self._queued = 0
        self.state = "killed"

    async def _stop_loop(self) -> None:
        await self._stop_pressure()
        if self._loop_task is None:
            return
        self._queue.put_nowait(None)   # sentinel unblocks the collector
        await self._loop_task
        self._loop_task = None

    async def _stop_pressure(self) -> None:
        if self._pressure_task is None:
            return
        self._pressure_task.cancel()
        try:
            await self._pressure_task
        except asyncio.CancelledError:
            pass
        self._pressure_task = None

    # ------------------------------------------------------- pressure loop

    async def _pressure_loop(self) -> None:
        """Poll the BudgetController between dispatch ticks.

        The tick runs in a worker thread UNDER ``_engine_lock`` — the same
        lock every engine-path dispatch holds — so a re-truncation always
        lands in the gap between two batches: the in-flight batch keeps the
        store view it captured at entry, the next batch sees the new one,
        and no batch is ever dropped or torn by a budget step.

        A tick cancelled (``drain``/``kill``) while its thread runs still
        finishes there; its step is awaited and counted before the
        cancellation goes on, so the books match the controller's."""
        interval = self.budget_ctl.pressure.check_interval_s
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(interval)
            tick = loop.run_in_executor(None, self._pressure_tick)
            try:
                step = await asyncio.shield(tick)
            except asyncio.CancelledError:
                self._count_step(await tick)
                raise
            self._count_step(step)

    def _count_step(self, step: Optional[str]) -> None:
        if step == "step_down":
            self._count("budget_steps_down")
        elif step == "step_up":
            self._count("budget_steps_up")

    def _pressure_tick(self) -> Optional[str]:
        with self._engine_lock:
            # a publish may have refreshed the engine (dropping the cut that
            # was made from the OLD labels) — re-assert the budget over the
            # newly published store before judging pressure
            self.budget_ctl.reapply()
            return self.budget_ctl.tick()

    # ---------------------------------------------------------- admission

    def _estimated_wait_s(self, n_new: int) -> float:
        """Expected time until a request submitted now is answered."""
        wait = self.cfg.batch_window_ms / 1000.0
        if self._rate_qps:
            wait += (self._queued + self._inflight + n_new) / self._rate_qps
        return wait

    async def submit(self, queries: np.ndarray,
                     deadline_ms: Optional[float] = None) -> np.ndarray:
        """Admit a request (int[B, 2] queries) and await its answers.

        Raises ``ShedError`` instead of queueing when the request cannot be
        served in budget — load shedding is the daemon telling the client
        *now* rather than timing out later."""
        queries = np.ascontiguousarray(np.asarray(queries, dtype=np.int32))
        n = int(queries.shape[0])
        self._count("submitted", n)
        # the admission span + trace id are the start of the request's
        # lifecycle in the exported timeline; sheds are terminal events on
        # the same id (guarded: this is the per-request hot path)
        tid = trace.new_trace_id() if ON.enabled else 0
        adm = trace.begin("admission", cat="request",
                          args={"trace_id": tid, "n": n}) if ON.enabled else None
        if self.state != "ready":
            self._count("shed_draining", n)
            if adm is not None:
                trace.end(adm)
                trace.event("shed", cat="request", reason="draining",
                            trace_id=tid)
            raise ShedError("draining", f"daemon state={self.state}")
        if self._queued + n > self.cfg.queue_limit:
            self._count("shed_queue_full", n)
            if adm is not None:
                trace.end(adm)
                trace.event("shed", cat="request", reason="queue_full",
                            trace_id=tid)
            raise ShedError("queue_full",
                            f"{self._queued} queued >= {self.cfg.queue_limit}")
        budget_s = (self.cfg.deadline_ms if deadline_ms is None
                    else float(deadline_ms)) / 1000.0
        if self._estimated_wait_s(n) > self.cfg.shed_headroom * budget_s:
            self._count("shed_deadline", n)
            if adm is not None:
                trace.end(adm)
                trace.event("shed", cat="request", reason="deadline",
                            trace_id=tid)
            raise ShedError("deadline",
                            f"est wait {self._estimated_wait_s(n) * 1000:.1f}ms "
                            f"> budget {budget_s * 1000:.0f}ms")
        now = time.monotonic()
        req = _Request(queries=queries, deadline=now + budget_s,
                       t_submit=now,
                       future=asyncio.get_running_loop().create_future(),
                       trace_id=tid)
        self._count("admitted", n)
        self._queued += n
        _QUEUE_DEPTH.set(self._queued)
        if adm is not None:
            trace.end(adm, admitted=True)
        self._queue.put_nowait(req)
        return await req.future

    # ------------------------------------------------------- batching loop

    async def _run(self) -> None:
        while True:
            req = await self._queue.get()
            if req is None:
                return
            batch = [req]
            size = req.queries.shape[0]
            t_end = time.monotonic() + self.cfg.batch_window_ms / 1000.0
            while size < self.cfg.max_batch:
                timeout = t_end - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                if nxt is None:
                    await self._dispatch(batch)
                    return
                batch.append(nxt)
                size += nxt.queries.shape[0]
            await self._dispatch(batch)

    async def _dispatch(self, batch: List[_Request]) -> None:
        now = time.monotonic()
        live: List[_Request] = []
        for req in batch:
            self._queued -= req.queries.shape[0]
            if req.deadline <= now:
                # admitted but its budget died in the queue: serving it would
                # only push live requests past THEIR deadlines
                self._count("shed_expired", req.queries.shape[0])
                if ON.enabled:
                    # the queue span ends here, terminally: expiry event
                    self._queue_span(req, now, expired=True)
                    trace.event("shed", cat="request", reason="expired",
                                trace_id=req.trace_id)
                req.future.set_exception(ShedError("expired"))
            else:
                if ON.enabled:
                    self._queue_span(req, now, expired=False)
                live.append(req)
        _QUEUE_DEPTH.set(self._queued)
        if not live:
            return
        q = np.concatenate([r.queries for r in live], axis=0)
        n = int(q.shape[0])
        batch_deadline = min(r.deadline for r in live)
        self._inflight = n
        self._count("batches")
        tick = trace.begin(
            "dispatch_tick", cat="daemon",
            args={"n_requests": len(live), "n_queries": n,
                  "trace_ids": [r.trace_id for r in live]}) if ON.enabled else None
        loop = asyncio.get_running_loop()
        try:
            t0 = time.monotonic()
            answers = await loop.run_in_executor(
                None, self._dispatch_sync, q, batch_deadline)
            dt = time.monotonic() - t0
        except asyncio.CancelledError:
            # kill() cancelled the loop mid-dispatch: the worker thread will
            # finish on its own, but its requests are dead to the client
            for req in live:
                if not req.future.done():
                    req.future.set_exception(ShedError("killed"))
                    self._count("shed_killed", req.queries.shape[0])
                    if ON.enabled:
                        trace.event("shed", cat="request", reason="killed",
                                    trace_id=req.trace_id)
            self._inflight = 0
            trace.end(tick, outcome="killed")
            raise
        except Exception as e:
            # a rung below already warned; requests fail loudly, not wrongly
            for req in live:
                if not req.future.done():
                    req.future.set_exception(e)
            self._inflight = 0
            trace.end(tick, outcome=f"error:{type(e).__name__}")
            return
        self._inflight = 0
        _DISPATCH_MS.observe(dt * 1000.0)
        trace.end(tick, outcome="answered")
        inst = n / max(dt, 1e-9)
        self._rate_qps = (inst if self._rate_qps is None
                          else 0.7 * self._rate_qps + 0.3 * inst)
        done = time.monotonic()
        lo = 0
        for req in live:
            hi = lo + req.queries.shape[0]
            if not req.future.done():   # kill() may have failed it already
                self._count("answered", hi - lo)
                lat_s = done - req.t_submit
                self.latencies.append(lat_s)
                _REQ_LATENCY.observe(lat_s * 1000.0)
                if ON.enabled:
                    trace.event("completed", cat="request",
                                trace_id=req.trace_id,
                                latency_ms=round(lat_s * 1000.0, 3))
                req.future.set_result(answers[lo:hi])
            lo = hi

    def _queue_span(self, req: _Request, now: float, expired: bool) -> None:
        """Retroactive queue-wait span: submit -> the dispatch tick that
        picked the request up (or expired it)."""
        t0 = trace._now_us() - (now - req.t_submit) * 1e6
        trace.TRACER._complete(
            "queue", "request", t0, (now - req.t_submit) * 1e6,
            {"trace_id": req.trace_id, "expired": expired})

    def _pad(self, q: np.ndarray) -> np.ndarray:
        """Pad the batch to a power-of-two row count (floor 64, cap
        max_batch) by repeating the first query.  Padding bounds the batch
        shapes to the ladder (at most 7 between 64 and 4,096), so
        ``ServeBatch``'s staging buffers, which grow by powers of two, grow
        at most once per rung.  Extra rows are real (duplicate) queries:
        verdicts stay exact; callers slice answers back to the true count."""
        n = int(q.shape[0])
        size = 64
        while size < n:
            size *= 2
        size = min(size, max(self.cfg.max_batch, n))
        if size == n:
            return q
        return np.concatenate([q, np.repeat(q[:1], size - n, axis=0)], axis=0)

    def _dispatch_sync(self, q: np.ndarray, deadline: float) -> np.ndarray:
        """One padded dispatch through breaker + ladder (worker thread)."""
        n = int(q.shape[0])
        q = self._pad(q)
        now = time.monotonic()
        if self._publishing and self._publish_pin is not None:
            # pinned-epoch rung: a publish is refreshing the engine right
            # now — serve from the epoch snapshot frozen at publish start
            self._count("pinned_epoch_batches")
            pin = self._publish_pin
            with trace.span("dispatch", cat="daemon",
                            args={"rung": "pinned_epoch", "padded": int(q.shape[0])}):
                try:
                    return pin.query_batch(q)[:n]
                except inject.SimulatedFailure:
                    # only an injected fault takes this rung; a real kernel
                    # failure raises through the request futures
                    self._count("pinned_device_to_host")
                    return pin.query_batch(q, device=False)[:n]
        use_device = (self.cfg.backend != "host"
                      and self.breaker.allow_device(now))
        with self._engine_lock:
            if not use_device:
                self._count("breaker_host_batches")
                with trace.span("dispatch", cat="daemon",
                                args={"rung": "host", "padded": int(q.shape[0]),
                                      "breaker": self.breaker.state}):
                    return self._serve(q, "host", deadline)[:n]
            self._count("device_batches")
            t0 = time.monotonic()
            with trace.span("dispatch", cat="daemon", annotate=True,
                            args={"rung": "device", "padded": int(q.shape[0])}):
                answers = self._serve(q, self.cfg.backend, deadline)
            dt = time.monotonic() - t0
            # failure signal for the breaker: the engine's ladder downgraded
            # the device dispatch (it already re-served the batch on the
            # host — answers are complete and correct), or the dispatch
            # blew the latency SLO
            degraded = self.engine.last_stats.get("degraded", {})
            device_failed = (degraded.get("device_to_host", 0) > 0
                             or degraded.get("deadline_to_host", 0) > 0)
        self.breaker.record(not device_failed and dt <= self.cfg.slo_s,
                            time.monotonic())
        return answers[:n]

    def _serve(self, q: np.ndarray, backend: Optional[str],
               deadline: float) -> np.ndarray:
        serve = getattr(self.target, "serve", None)
        if serve is not None:
            return serve(q, backend=backend, deadline=deadline)
        return self.engine.query_batch(q, backend=backend, deadline=deadline)

    # ------------------------------------------------------------ publish

    async def publish(self, update_batch=None) -> int:
        """Apply an update batch (optional) and publish a new epoch without
        stalling serving: the current epoch is pinned first, the publish
        runs in a worker thread, and every batch dispatched meanwhile routes
        to the pinned snapshot — an in-flight batch can never observe the
        engine mid-refresh."""
        if not self._dynamic:
            raise RuntimeError("publish() requires a dynamic oracle target")
        self._publish_pin = self.target.snapshot()
        self._publishing = True
        loop = asyncio.get_running_loop()

        def _apply_publish():
            # the engine lock lets at most one already-started engine-path
            # dispatch finish before the publish may refresh the engine;
            # batches formed after the pin flag flipped route to the pinned
            # snapshot and never contend here
            with self._engine_lock:
                if update_batch is not None:
                    self.target.apply(update_batch)
                return self.target.publish()

        try:
            with trace.span("daemon.publish", cat="daemon"):
                epoch = await loop.run_in_executor(None, _apply_publish)
        finally:
            self._publishing = False
            self._publish_pin = None
        self._count("publishes")
        return int(epoch)

    # ------------------------------------------------------------- health

    def _latency_pctiles(self) -> dict:
        if not self.latencies:
            return {"p50_ms": None, "p99_ms": None}
        arr = np.asarray(self.latencies)
        return {"p50_ms": round(float(np.quantile(arr, 0.5)) * 1000, 3),
                "p99_ms": round(float(np.quantile(arr, 0.99)) * 1000, 3)}

    def health(self) -> dict:
        """Health/readiness snapshot: daemon state + breaker + queue +
        latency + the engine's consistent ``stats()`` snapshot (degradation
        counters included) — everything an operator needs to tell "shedding
        under overload" from "serving garbage"."""
        now = time.monotonic()
        c = self.counters
        shed = (c["shed_queue_full"] + c["shed_deadline"]
                + c["shed_draining"] + c["shed_expired"] + c["shed_killed"])
        return {
            "state": self.state,
            "ready": self.state == "ready",
            "dynamic": self._dynamic,
            "epoch": int(getattr(self.target, "epoch", self.engine.epoch)),
            "publishing": self._publishing,
            "queue_depth": self._queued,
            "inflight": self._inflight,
            "service_rate_qps": None if self._rate_qps is None else round(self._rate_qps),
            "shed_total": shed,
            "shed_rate": round(shed / c["submitted"], 4) if c["submitted"] else 0.0,
            "breaker": self.breaker.snapshot(now),
            "counters": dict(c),
            "latency": self._latency_pctiles(),
            "budget": (None if self.budget_ctl is None
                       else self.budget_ctl.snapshot()),
            "engine": self.engine.stats(),
            # the process-global registry: one surface over daemon, engine,
            # build, dynamic, and fault-injection metrics
            "metrics": metrics.snapshot(),
        }
