"""The port's serving daemon and open-loop driver, on the CPU.

Every test of ``tests/test_daemon.py`` has its counterpart here, over the
port's ``CondensedOracle`` (admission and shedding, deadlines, the circuit
breaker, pinned-epoch publishes, drain/kill, the stats and health
surfaces).  The pinned-epoch tests run on a minimal duck-typed dynamic
target (``snapshot`` / ``apply`` / ``publish``) and on the port's
``DynamicOracle``, as ``tests/test_daemon.py`` runs them on ``repro``'s.

Then differential tests against ``repro``'s daemon on the same inputs: the
same request stream with shedding off gives equal answers; under the same
injected occurrences the timing-free counters (``device_batches``,
``breaker_host_batches``, the breaker's state sequence) are equal;
``check_truth`` counts the same wrong answers; the pressure loop's tick
takes the same budget steps; the open-loop driver draws the same arrivals;
and ``launch/serve.py --mode daemon --device cpu`` runs.

Where wall-clock matters the margins are coarse (a 150ms injected stall
against a 30ms deadline), so the assertions hold under CI scheduling jitter.
"""
import asyncio
import json
import threading
import time
import warnings

import numpy as np
import pytest

import repro.core.api as japi
import repro.ft.inject as jinject
import repro.serve.budget as jbudget
import repro.serve.daemon as jdaemon
import repro.serve.openloop as jopenloop
from repro.dynamic.workload import poisson_times as jpoisson_times
from repro.graph.generators import random_dag
import repro_torch.core.api as tapi
import repro_torch.graph.csr as tcsr
import repro_torch.serve.budget as tbudget
import repro_torch.serve.daemon as tdaemon
import repro_torch.serve.openloop as topenloop
from repro_torch.dynamic.workload import poisson_times as tpoisson_times
from repro_torch.ft import inject
from repro_torch.graph.scc import condense_to_dag
from repro_torch.launch import serve as tserve
from repro_torch.obs import metrics as tmetrics
from repro_torch.serve.daemon import (
    CircuitBreaker,
    DaemonConfig,
    ServeDaemon,
    ShedError,
)
from repro_torch.serve.engine import QueryEngine
from test_serve_engine import _truth_matrix

JG = random_dag(300, 1000, seed=7)


def _port_graph(g):
    return tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())


G = _port_graph(JG)


@pytest.fixture(scope="module")
def co():
    return tapi.build_oracle(G, device="cpu")


@pytest.fixture(scope="module")
def jco():
    return japi.build_oracle(JG)


def _queries(rng, k=64):
    return rng.integers(0, G.n, size=(k, 2)).astype(np.int32)


# ------------------------------------------------------------ happy path


def test_roundtrip_answers_match_host_then_drains_clean(co, rng):
    qs = [_queries(rng) for _ in range(5)]
    want = [co.engine.query_batch(q, backend="host") for q in qs]

    async def go():
        daemon = ServeDaemon(co, DaemonConfig(batch_window_ms=1.0))
        await daemon.start()
        got = await asyncio.gather(*(daemon.submit(q) for q in qs))
        stats = await daemon.drain()
        return daemon, got, stats

    daemon, got, stats = asyncio.run(go())
    for w, g_ in zip(want, got):
        assert (w == g_).all()
    assert daemon.state == "stopped"
    assert stats["answered"] == stats["admitted"] == 5 * 64
    assert daemon.health()["ready"] is False
    assert daemon.health()["queue_depth"] == 0


# ------------------------------------------------------------- admission


def test_queue_full_sheds(co, rng):
    async def go():
        daemon = ServeDaemon(co, DaemonConfig(queue_limit=64))
        daemon.state = "ready"   # admission open, batch loop deliberately off
        first = asyncio.ensure_future(daemon.submit(_queries(rng, 64)))
        await asyncio.sleep(0)   # let it enqueue
        with pytest.raises(ShedError) as ei:
            await daemon.submit(_queries(rng, 1))
        first.cancel()
        return ei.value.reason, daemon.counters["shed_queue_full"]

    reason, n = asyncio.run(go())
    assert reason == "queue_full"
    assert n == 1


def test_deadline_budget_sheds_at_admission(co, rng):
    async def go():
        daemon = ServeDaemon(co, DaemonConfig())
        daemon.state = "ready"
        daemon._rate_qps = 50.0   # 64 queries => ~1.3s estimated wait
        with pytest.raises(ShedError) as ei:
            await daemon.submit(_queries(rng, 64), deadline_ms=10.0)
        return ei.value.reason

    assert asyncio.run(go()) == "deadline"


def test_draining_state_sheds(co, rng):
    async def go():
        daemon = ServeDaemon(co, DaemonConfig())
        daemon.state = "draining"
        with pytest.raises(ShedError) as ei:
            await daemon.submit(_queries(rng, 4))
        return ei.value.reason

    assert asyncio.run(go()) == "draining"


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_expired_in_queue_sheds_at_dispatch(co, rng, backend):
    """A request whose budget dies while an injected stall holds the
    dispatch must shed as ``expired``, never be served late."""
    plan = inject.Injector(latency={"serve.device_dispatch": ([0], 0.15)})

    async def go():
        daemon = ServeDaemon(
            co, DaemonConfig(batch_window_ms=1.0, backend=backend))
        await daemon.start()
        with inject.active(plan):
            slow = asyncio.ensure_future(
                daemon.submit(_queries(rng), deadline_ms=5000.0))
            await asyncio.sleep(0.03)   # stalled dispatch now in flight
            doomed = asyncio.ensure_future(
                daemon.submit(_queries(rng, 32), deadline_ms=30.0))
            ans = await slow
            with pytest.raises(ShedError) as ei:
                await doomed
        await daemon.drain()
        return ans, ei.value.reason, daemon.counters["shed_expired"]

    ans, reason, n_expired = asyncio.run(go())
    assert ans.shape == (64,)
    assert reason == "expired"
    assert n_expired == 32


# --------------------------------------------------------------- breaker


def test_breaker_unit_lifecycle():
    br = CircuitBreaker(failures=2, backoff_s=1.0, backoff_max_s=4.0)
    assert br.allow_device(0.0)
    br.record(False, 0.0)
    assert br.state == "closed"          # one failure: under threshold
    br.record(False, 0.0)
    assert br.state == "open" and br.trips == 1
    assert not br.allow_device(0.5)      # backoff still running
    assert br.allow_device(1.5)          # elapsed: half_open probe allowed
    br.record(False, 1.5)                # failed probe: reopen, doubled
    assert br.state == "open" and br.backoff == 2.0 and br.trips == 2
    assert br.allow_device(4.0)
    br.record(True, 4.0)                 # healthy probe: closed, full reset
    assert br.state == "closed" and br.backoff == 1.0


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_consecutive_device_failures_trip_breaker_then_reprobe(co, rng, backend):
    plan = inject.Injector({"serve.device_dispatch": [0, 1]})
    q_check = _queries(rng, 32)
    want = co.engine.query_batch(q_check, backend="host")
    co.engine.reset_stats()

    async def go():
        daemon = ServeDaemon(co, DaemonConfig(
            batch_window_ms=1.0, backend=backend, deadline_ms=10_000.0,
            breaker_failures=2, breaker_backoff_ms=60.0))
        await daemon.start()
        rng2 = np.random.default_rng(0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with inject.active(plan):
                # two failing dispatches: engine downgrades each to host
                # (answers stay correct), breaker counts and trips
                for _ in range(2):
                    await daemon.submit(_queries(rng2))
                tripped = daemon.breaker.state
                # breaker open: batches route straight to host
                await daemon.submit(_queries(rng2))
                host_batches = daemon.counters["breaker_host_batches"]
                await asyncio.sleep(0.1)   # past the backoff: re-probe
                await daemon.submit(_queries(rng2))
                reprobed = daemon.breaker.state
        await daemon.drain()
        return daemon, tripped, host_batches, reprobed

    daemon, tripped, host_batches, reprobed = asyncio.run(go())
    assert tripped == "open"
    assert daemon.breaker.trips == 1
    assert host_batches >= 1
    assert reprobed == "closed"          # healthy probe closed it
    assert daemon.engine.degradation["device_to_host"] > 0
    # every answer correct throughout (spot check one fresh batch)
    got = asyncio.run(_one_shot(daemon.target, q_check))
    assert (got == want).all()


async def _one_shot(target, q):
    daemon = ServeDaemon(target, DaemonConfig(batch_window_ms=1.0))
    await daemon.start()
    ans = await daemon.submit(q)
    await daemon.drain()
    return ans


def test_latency_slo_breach_trips_breaker(co, rng):
    plan = inject.Injector(latency={"serve.device_dispatch": ([0], 0.08)})

    async def go():
        daemon = ServeDaemon(co, DaemonConfig(
            batch_window_ms=1.0, backend="dense",
            breaker_failures=1, breaker_slo_ms=20.0))
        await daemon.start()
        with inject.active(plan):
            ans = await daemon.submit(_queries(rng))
        state = daemon.breaker.state
        await daemon.drain()
        return ans, state, daemon.breaker.trips

    ans, state, trips = asyncio.run(go())
    assert ans.shape == (64,)
    assert state == "open" and trips == 1


# ------------------------------------------------- pinned-epoch publishes


class _Pin:
    """The epoch frozen at ``snapshot``: its own engine over its labels."""

    def __init__(self, oracle, comp, level, dag):
        self._engine = QueryEngine(oracle, level=level, fallback_graph=dag, device="cpu")
        self._engine.comp_source = lambda: comp

    def query_batch(self, q, device=True):
        return self._engine.query_batch(q, backend="dense" if device else "host")


class _DuckDynamic:
    """The least a dynamic target offers the daemon: ``snapshot``, ``apply``
    (edge inserts, kept pending) and ``publish`` (rebuild, then refresh the
    one engine in place; the ``dynamic.publish`` fault site fires first)."""

    def __init__(self, g):
        self.g = g
        co = tapi.build_oracle(g, device="cpu")
        self.engine, self.comp, self.epoch = co.engine, co.comp, 0
        self.engine.comp_source = lambda: self.comp
        self._dag = condense_to_dag(g)[0]
        self._pending = []

    def serve(self, q, backend=None, deadline=None):
        return self.engine.query_batch(q, backend=backend, deadline=deadline)

    def snapshot(self):
        return _Pin(self.engine.oracle, self.comp, self.engine.level, self._dag)

    def apply(self, edges):
        self._pending.extend(edges)

    def publish(self):
        inject.fire("dynamic.publish")
        src, dst = self.g.edges()
        add = np.asarray(self._pending, dtype=np.int64).reshape(-1, 2)
        self.g = tcsr.from_edges(self.g.n, np.concatenate([src, add[:, 0]]),
                                 np.concatenate([dst, add[:, 1]]))
        self._pending = []
        co = tapi.build_oracle(self.g, device="cpu")
        self._dag = condense_to_dag(self.g)[0]
        self.engine.refresh(co.oracle, level=co.engine.level, fallback_graph=self._dag)
        self.comp = co.comp
        self.epoch += 1
        return self.epoch


def test_publish_pins_epoch_and_new_epoch_serves_after(rng):
    g = _port_graph(random_dag(200, 600, seed=3))
    dyn = _DuckDynamic(g)
    q = rng.integers(0, g.n, size=(256, 2)).astype(np.int32)
    want_old = dyn.serve(q)
    topo_edges = [(int(u), int(v)) for u, v in
                  zip(rng.integers(0, g.n // 2, 8),
                      rng.integers(g.n // 2, g.n, 8)) if u != v]
    plan = inject.Injector(latency={"dynamic.publish": ([0], 0.2)})

    async def go():
        daemon = ServeDaemon(dyn, DaemonConfig(batch_window_ms=1.0,
                                               deadline_ms=10_000.0))
        await daemon.start()
        with inject.active(plan):
            pub = asyncio.ensure_future(daemon.publish(topo_edges))
            await asyncio.sleep(0.05)    # publish pinned + stalled
            assert daemon.health()["publishing"] is True
            during = await daemon.submit(q)
            epoch = await pub
        after = await daemon.submit(q)
        await daemon.drain()
        return daemon, during, after, epoch

    daemon, during, after, epoch = asyncio.run(go())
    # the batch dispatched mid-publish served from the pinned epoch: its
    # verdicts are exactly the pre-publish verdicts
    assert daemon.counters["pinned_epoch_batches"] >= 1
    assert (during == want_old).all()
    assert epoch >= 1
    assert daemon.counters["publishes"] == 1
    assert daemon.health()["epoch"] == epoch
    src, dst = g.edges()
    edges = np.asarray(topo_edges)
    truth = _truth_matrix(g.n, np.concatenate([src, edges[:, 0]]),
                          np.concatenate([dst, edges[:, 1]]))
    assert (after == truth[q[:, 0], q[:, 1]]).all()


def test_publish_pins_epoch_on_a_dynamic_oracle(rng):
    """``tests/test_daemon.py``'s publish test on the port's DynamicOracle:
    the batch served mid-publish is the pinned epoch's (pinned epochs serve
    through K1's tier form; its plain version here), the new epoch serves
    after, and both equal ``repro``'s DynamicOracle on the same updates."""
    import repro.dynamic as jdyn
    import repro_torch.dynamic as tdyn

    jg = random_dag(200, 600, seed=3)
    dyn = tdyn.DynamicOracle(_port_graph(jg), device="cpu")
    q = rng.integers(0, jg.n, size=(256, 2)).astype(np.int32)
    want_old = dyn.serve(q)
    topo_edges = [(int(u), int(v)) for u, v in
                  zip(rng.integers(0, jg.n // 2, 8),
                      rng.integers(jg.n // 2, jg.n, 8)) if u != v]
    batch = tdyn.UpdateBatch.of(inserts=topo_edges)
    plan = inject.Injector(latency={"dynamic.publish": ([0], 0.2)})

    async def go():
        daemon = ServeDaemon(dyn, DaemonConfig(batch_window_ms=1.0,
                                               deadline_ms=10_000.0))
        await daemon.start()
        with inject.active(plan):
            pub = asyncio.ensure_future(daemon.publish(batch))
            await asyncio.sleep(0.05)    # publish pinned + stalled
            assert daemon.health()["publishing"] is True
            during = await daemon.submit(q)
            epoch = await pub
        after = await daemon.submit(q)
        await daemon.drain()
        return daemon, during, after, epoch

    daemon, during, after, epoch = asyncio.run(go())
    assert daemon.counters["pinned_epoch_batches"] >= 1
    assert daemon.counters["pinned_device_to_host"] == 0
    assert (during == want_old).all()
    assert epoch == dyn.epoch == 1
    assert daemon.counters["publishes"] == 1
    ref = jdyn.DynamicOracle(jg)
    assert (want_old == ref.serve(q)).all()
    ref.apply(jdyn.UpdateBatch.of(inserts=topo_edges))
    ref.publish()
    assert (after == ref.serve(q)).all()
    assert (dyn.serve(q, epoch=0) == want_old).all()


def test_pinned_epoch_injected_failure_on_a_dynamic_oracle(rng, monkeypatch):
    """An injected failure on a real pinned epoch's device path takes the
    pinned host rung, counted, with the pinned epoch's verdicts."""
    import repro_torch.dynamic as tdyn
    import repro_torch.dynamic.versioned as tversioned

    g = _port_graph(random_dag(200, 600, seed=5))
    dyn = tdyn.DynamicOracle(g, device="cpu")
    q = rng.integers(0, g.n, size=(256, 2)).astype(np.int32)
    want_old = dyn.serve(q)
    orig = tversioned.LabelEpoch.query_batch

    def failing(self, queries, device=True):
        if device:
            raise inject.SimulatedFailure("pinned device path")
        return orig(self, queries, device=False)

    plan = inject.Injector(latency={"dynamic.publish": ([0], 0.2)})

    async def go():
        daemon = ServeDaemon(dyn, DaemonConfig(batch_window_ms=1.0, deadline_ms=10_000.0))
        await daemon.start()
        with inject.active(plan):
            pub = asyncio.ensure_future(daemon.publish(tdyn.UpdateBatch.of(inserts=[(0, 199)])))
            await asyncio.sleep(0.05)
            during = await daemon.submit(q)
            await pub
        await daemon.drain()
        return daemon, during

    monkeypatch.setattr(tversioned.LabelEpoch, "query_batch", failing)
    daemon, during = asyncio.run(go())
    assert daemon.counters["pinned_epoch_batches"] >= 1
    assert daemon.counters["pinned_device_to_host"] >= 1
    assert (during == want_old).all()


class _FailingPin(_Pin):
    """A pinned epoch whose device path raises ``exc`` on every call."""

    def __init__(self, exc, *args):
        super().__init__(*args)
        self._exc = exc

    def query_batch(self, q, device=True):
        if device:
            raise self._exc("pinned epoch's device path failed")
        return super().query_batch(q, device=False)


@pytest.mark.parametrize("exc", [inject.SimulatedFailure, RuntimeError])
def test_pinned_epoch_host_rung_only_for_injected_failure(rng, exc):
    """Only an injected fault takes the pinned epoch's device -> host rung;
    a real failure reaches the client and is never re-served on the host."""
    g = _port_graph(random_dag(200, 600, seed=3))
    dyn = _DuckDynamic(g)
    dyn.snapshot = lambda: _FailingPin(exc, dyn.engine.oracle, dyn.comp,
                                       dyn.engine.level, dyn._dag)
    q = rng.integers(0, g.n, size=(256, 2)).astype(np.int32)
    want_old = dyn.serve(q)
    plan = inject.Injector(latency={"dynamic.publish": ([0], 0.2)})

    async def go():
        daemon = ServeDaemon(dyn, DaemonConfig(batch_window_ms=1.0,
                                               deadline_ms=10_000.0))
        await daemon.start()
        with inject.active(plan):
            pub = asyncio.ensure_future(daemon.publish())
            await asyncio.sleep(0.05)    # publish pinned + stalled
            assert daemon.health()["publishing"] is True
            try:
                during = await daemon.submit(q)
            except RuntimeError as e:
                during = e
            await pub
        await daemon.drain()
        return daemon, during

    daemon, during = asyncio.run(go())
    assert daemon.counters["pinned_epoch_batches"] >= 1
    if exc is inject.SimulatedFailure:
        assert daemon.counters["pinned_device_to_host"] >= 1
        assert (during == want_old).all()
    else:
        assert type(during) is RuntimeError
        assert "pinned epoch's device path failed" in str(during)
        assert daemon.counters["pinned_device_to_host"] == 0


def test_publish_refused_on_a_static_target(co):
    async def go():
        daemon = ServeDaemon(co, DaemonConfig())
        with pytest.raises(RuntimeError, match="dynamic oracle"):
            await daemon.publish()

    asyncio.run(go())


# ------------------------------------------------------------- lifecycle


def test_kill_fails_pending_and_closes_admission(co, rng):
    async def go():
        daemon = ServeDaemon(co, DaemonConfig())
        daemon.state = "ready"   # loop off: requests stay queued
        pend = asyncio.ensure_future(daemon.submit(_queries(rng)))
        await asyncio.sleep(0)
        await daemon.kill()
        with pytest.raises(ShedError) as ei:
            await pend
        reason = ei.value.reason
        with pytest.raises(ShedError) as ei2:
            await daemon.submit(_queries(rng, 4))
        return daemon, reason, ei2.value.reason

    daemon, reason, after_reason = asyncio.run(go())
    assert reason == "killed"
    assert daemon.state == "killed"
    assert after_reason == "draining"
    assert daemon.counters["shed_killed"] == 64


# --------------------------------------------------- stats/health surfaces


def test_engine_stats_snapshot_is_consistent_copy(co, rng):
    co.engine.query_batch(_queries(rng), backend="host")
    s = co.engine.stats()
    assert s["backend"] in ("host", "dense", "kernel")
    assert s["last_batch"]["n_queries"] == 64
    # mutating the snapshot must not leak into the engine
    s["degradation"]["searched"] = 10 ** 9
    s["last_batch"]["n_queries"] = -1
    s2 = co.engine.stats()
    assert s2["degradation"]["searched"] != 10 ** 9
    assert s2["last_batch"]["n_queries"] == 64


def test_engine_reset_stats(co, rng):
    qmask = np.ones(co.oracle.n, dtype=bool)
    co.engine.set_quarantine(qmask, None)
    co.engine.query_batch(_queries(rng), backend="host")
    co.engine.set_quarantine(None, None)
    assert co.engine.degradation["searched"] > 0
    co.engine.reset_stats()
    assert all(v == 0 for v in co.engine.degradation.values())
    assert co.engine.stats()["last_batch"] == {}


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_engine_deadline_degrades_to_host_same_verdicts(co, rng, backend):
    q = _queries(rng, 128)
    want = co.engine.query_batch(q, backend="host")
    got = co.engine.query_batch(q, backend=backend,
                                deadline=time.monotonic() - 1.0)
    assert (got == want).all()
    assert co.engine.last_stats["degraded"]["deadline_to_host"] > 0


def test_health_surfaces_breaker_and_degradation(co, rng):
    async def go():
        daemon = ServeDaemon(co, DaemonConfig())
        await daemon.start()
        await daemon.submit(_queries(rng))
        h = daemon.health()
        await daemon.drain()
        return h

    h = asyncio.run(go())
    assert h["ready"] is True
    assert h["breaker"]["state"] == "closed"
    assert h["counters"]["answered"] == 64
    assert "degradation" in h["engine"]
    assert h["shed_rate"] == 0.0
    assert "daemon_requests_total" in h["metrics"]


# ------------------------------------------------- against repro's daemon


def _sequential(daemon_mod, target, cfg, qs, plan_mod=None, plan=None, sleep_after=None):
    """Submit ``qs`` one at a time (one dispatch each); return the answers
    and the breaker state after each submit, then the daemon."""
    async def go():
        daemon = daemon_mod.ServeDaemon(target, cfg)
        await daemon.start()
        answers, states = [], []
        for i, q in enumerate(qs):
            if sleep_after is not None and i == sleep_after:
                await asyncio.sleep(0.7)   # past the 500 ms backoff: re-probe
            answers.append(await daemon.submit(q))
            states.append(daemon.breaker.state)
        await daemon.drain()
        return daemon, answers, states

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if plan is None:
            return asyncio.run(go())
        with plan_mod.active(plan):
            return asyncio.run(go())


def test_same_stream_gives_jax_daemon_answers(co, jco):
    """Shedding off (room in the queue, no deadline pressure): a burst of
    concurrent requests gets the JAX daemon's answers, request for request."""
    rng = np.random.default_rng(5)
    qs = [_queries(rng, int(k)) for k in rng.integers(1, 200, 40)]

    def burst(daemon_mod, target):
        async def go():
            daemon = daemon_mod.ServeDaemon(target, daemon_mod.DaemonConfig(
                batch_window_ms=2.0, deadline_ms=60_000.0, queue_limit=1 << 20))
            await daemon.start()
            got = await asyncio.gather(*(daemon.submit(q) for q in qs))
            await daemon.drain()
            return daemon, got

        return asyncio.run(go())

    jd, jgot = burst(jdaemon, jco)
    td, tgot = burst(tdaemon, co)
    for a, b in zip(tgot, jgot):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    n = sum(q.shape[0] for q in qs)
    for d in (jd, td):
        assert d.counters["answered"] == d.counters["submitted"] == n
        assert not any(v for k, v in d.counters.items() if k.startswith("shed_"))


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_injected_faults_give_jax_timing_free_counters(co, jco, backend):
    """The same injected occurrences through both daemons, one dispatch a
    request: the breaker's state after each request, ``device_batches``,
    ``breaker_host_batches``, the trips and the engine's ``device_to_host``
    are the JAX daemon's (the JAX side serves ``dense``: its ``kernel`` is
    the Pallas interpreter, and both fire the fault site once a batch)."""
    rng = np.random.default_rng(9)
    qs = [_queries(rng, 64) for _ in range(9)]
    # dispatches 1-2 fail (the breaker trips), 3-4 go to the host, the
    # re-probe after the sleep closes it, dispatch 6 (the 5th fault-site
    # occurrence) fails alone
    occ = [1, 2, 4]

    def cfg(mod, be):
        return mod.DaemonConfig(batch_window_ms=1.0, backend=be, deadline_ms=60_000.0,
                                breaker_failures=2, breaker_backoff_ms=500.0,
                                breaker_slo_ms=60_000.0)

    jco.engine.reset_stats()
    co.engine.reset_stats()
    jd, jans, jstates = _sequential(jdaemon, jco, cfg(jdaemon, "dense"), qs, jinject,
                                    jinject.Injector({"serve.device_dispatch": occ}),
                                    sleep_after=5)
    td, tans, tstates = _sequential(
        tdaemon, co,
        cfg(tdaemon, backend), qs, inject,
        inject.Injector({"serve.device_dispatch": occ}), sleep_after=5)
    assert tstates == jstates == ["closed"] * 2 + ["open"] * 3 + ["closed"] * 4
    for k in ("device_batches", "breaker_host_batches", "batches", "answered"):
        assert td.counters[k] == jd.counters[k], k
    assert td.breaker.trips == jd.breaker.trips
    assert td.engine.degradation["device_to_host"] == jd.engine.degradation["device_to_host"] > 0
    for a, b in zip(tans, jans):
        assert np.array_equal(a, b)


def test_check_truth_matches_jax(co):
    rng = np.random.default_rng(2)
    q = _queries(rng, 300)
    ans = co.engine.query_batch(q, backend="host")
    ans[::7] = ~ans[::7]     # some wrong answers to count
    for limit in (50, 200, 300):
        assert topenloop.check_truth(G, q, ans, limit=limit) == \
            jopenloop.check_truth(JG, q, ans, limit=limit) > 0


def test_poisson_arrivals_match_jax():
    for rate, dur, seed in ((400.0, 3.0, 0), (120.0, 4.0, 1), (5.0, 0.5, 7)):
        a, b = tpoisson_times(rate, dur, seed=seed), jpoisson_times(rate, dur, seed=seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_pressure_tick_takes_jax_budget_steps(co, jco):
    """The daemon's pressure tick (the loop's body: ``reapply`` then ``tick``
    under the engine lock) over the same scripted pressure signal takes the
    JAX daemon's steps, and both leave the same resident bytes."""
    full = tbudget.label_bytes(co.oracle)
    script = [2.0, 2.0, 0.2, 0.2, 0.2, 0.2, 2.0, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1]
    mark = int(full * 0.9)

    def run(budget_mod, daemon_mod, target):
        it = iter(script)
        ctl = budget_mod.BudgetController(
            target.engine, pressure=budget_mod.PressureConfig(watermark_bytes=mark),
            pressure_source=lambda: next(it) * mark)
        daemon = daemon_mod.ServeDaemon(target, daemon_mod.DaemonConfig(), budget_ctl=ctl)
        steps = [daemon._pressure_tick() for _ in script]
        snap = ctl.snapshot()
        ctl.apply(None)
        return steps, snap

    tsteps, tsnap = run(tbudget, tdaemon, co)
    jsteps, jsnap = run(jbudget, jdaemon, jco)
    assert tsteps == jsteps and "step_down" in tsteps and "step_up" in tsteps
    assert tsnap == jsnap


def test_pressure_loop_steps_down_live_and_reconciles(co):
    """The live loop: a signal over the watermark steps the budget down
    between dispatch ticks, answers stay exact, and the registry mirrors
    the daemon's books."""
    mark = int(tbudget.label_bytes(co.oracle) * 0.75)
    ctl = tbudget.BudgetController(
        co.engine, pressure=tbudget.PressureConfig(watermark_bytes=mark, check_interval_s=0.01))
    tmetrics.REGISTRY.reset()
    try:
        rep = topenloop.run_open_loop(co, G, rate_arrivals_per_s=100.0, duration_s=0.6,
                                      deadline_ms=5000.0, seed=3, budget_ctl=ctl)
    finally:
        ctl.apply(None)
    assert rep["sample_errors"] == 0 and rep["answered"] == rep["submitted"]
    assert rep["budget"]["steps_down"] >= 1
    reg = tmetrics.REGISTRY
    assert reg.counter_value("daemon_budget_steps_total", direction="down") == \
        rep["budget"]["steps_down"]
    assert reg.counter_value("daemon_requests_total", event="answered") == rep["answered"]


def test_pressure_tick_in_flight_at_drain_is_counted(co):
    """A drain that cancels the pressure loop while a tick runs in its
    thread: the tick finishes, and its step is in the daemon's books and
    the registry as it is in the controller's (``repro``'s loop drops it)."""
    mark = int(tbudget.label_bytes(co.oracle) * 0.75)
    entered, release = threading.Event(), threading.Event()
    calls = []

    def source():
        calls.append(1)
        if len(calls) == 1:      # the first tick blocks until the drain is under way
            entered.set()
            release.wait(10.0)
            return 2.0 * mark
        return 0.8 * mark        # between the watermarks: no step

    ctl = tbudget.BudgetController(
        co.engine, pressure=tbudget.PressureConfig(watermark_bytes=mark, check_interval_s=0.01),
        pressure_source=source)

    async def go():
        daemon = ServeDaemon(co, DaemonConfig(), budget_ctl=ctl)
        await daemon.start()
        while not entered.is_set():
            await asyncio.sleep(0.005)
        timer = threading.Timer(0.1, release.set)
        timer.start()
        await daemon.drain()
        timer.join(5.0)
        return daemon

    tmetrics.REGISTRY.reset()
    try:
        daemon = asyncio.run(go())
        steps = ctl.snapshot()["steps_down"]
    finally:
        ctl.apply(None)
    assert steps == 1 == daemon.counters["budget_steps_down"]
    assert tmetrics.REGISTRY.counter_value("daemon_budget_steps_total", direction="down") == 1


def test_run_open_loop_report_matches_jax_shape(co, jco):
    """The same arrivals and queries from one seed: the report has the JAX
    driver's keys, the same arrival count, and every answer is exact."""
    kw = dict(rate_arrivals_per_s=150.0, duration_s=0.5, deadline_ms=5000.0, seed=4)
    trep = topenloop.run_open_loop(co, G, **kw)
    jrep = jopenloop.run_open_loop(jco, JG, **kw)
    assert set(trep) == set(jrep)
    for k in ("n_arrivals", "submitted", "offered_qps", "sample_errors"):
        assert trep[k] == jrep[k], k
    assert trep["sample_errors"] == 0 and trep["answered"] == trep["submitted"]


def test_serve_driver_daemon_mode_runs_on_cpu(tmp_path, capsys):
    out, met, tr = tmp_path / "d.json", tmp_path / "m.json", tmp_path / "t.json"
    argv = ["--mode", "daemon", "--device", "cpu", "--dataset", "kegg", "--scale", "1.0",
            "--rate", "150", "--duration", "0.8"]
    rec = tserve.main(argv + ["--inject-device-latency", "2-3:30",
                              "--inject-device-failure", "5-7", "--breaker-failures", "2",
                              "--json-out", str(out), "--metrics-out", str(met),
                              "--trace-out", str(tr)])
    assert "daemon: answered" in capsys.readouterr().out
    assert rec["mode"] == "daemon" and rec["torch_device"] == "cpu"
    rep = rec["report"]
    assert rep["sample_errors"] == 0 and rep["faults"]["failed"] and rep["faults"]["stalled"]
    assert rep["degradation"]["device_to_host"] > 0 and rep["breaker"]["trips"] >= 1
    assert json.loads(out.read_text())["report"]["answered"] == rep["answered"]
    snap = json.loads(met.read_text())
    assert snap["daemon_requests_total"]["values"].get("event=answered", 0) == rep["answered"]
    assert json.loads(tr.read_text())["traceEvents"]
    # under a budget, with the pressure loop armed below the resident bytes
    rec = tserve.main(argv + ["--budget-mb", "0.25", "--pressure-watermark", "0.1"])
    assert "budget:" in capsys.readouterr().out
    b = rec["report"]["budget"]
    assert rec["report"]["sample_errors"] == 0 and b["steps_down"] >= 1
    assert b["resident_bytes"] < b["full_bytes"]
    # over a durable dynamic oracle: started in the state dir, then recovered
    state = str(tmp_path / "state")
    for line in ("durable oracle initialized at", "recovered durable oracle from"):
        rec = tserve.main(argv + ["--state-dir", state])
        assert line in capsys.readouterr().out
        assert rec["report"]["sample_errors"] == 0
        assert rec["report"]["answered"] == rec["report"]["submitted"]
        assert rec["health"]["dynamic"] is True and rec["health"]["epoch"] == 0


def test_serve_driver_sweep_takes_an_injected_failure(capsys):
    """Sweep mode keeps the JAX driver's single-occurrence failure flag: the
    faulted batch degrades to the host merge, counted, and the run passes."""
    rec = tserve.main(["--device", "cpu", "--dataset", "kegg", "--scale", "1.0",
                       "--n-queries", "3000", "--batch", "1024", "--backend", "all",
                       "--inject-device-failure", "1"])
    assert "degradation: device->host=" in capsys.readouterr().out
    for be in ("dense", "kernel"):
        deg = rec["backends"][be]["degradation"]
        assert deg["device_to_host"] > 0 and rec["backends"][be]["sample_errors"] == 0
        assert not any(v for k, v in deg.items() if k != "device_to_host")
    assert not any(rec["backends"]["host"]["degradation"].values())
