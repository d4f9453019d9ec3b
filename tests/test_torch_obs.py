"""The port's tracer (``repro_torch.obs.trace``) and the build's spans.

  * the tracer's clock is the profiler's: an annotated span starts within
    100 µs of its ``record_function`` range,
  * a full ring counts what it drops, and ``clear()`` drops the device
    timings still pending,
  * the device iteration (``make_sharded_distribute_one``) traces one
    ``build.iteration`` a call, a ``build.pass`` a pass with one
    ``build.prune``, a ``build.bfs_step`` a BFS step and one
    ``build.append`` inside it, a step a level of a plain BFS and one
    more; with ``obs`` off it traces nothing and leaves the same label
    state,
  * a span times its block on the card only with annotations on: without
    them a span given a CUDA device stays host-only,
  * (``cuda``) every device-timed span of a call on the card has its
    ``device_ms``, and their sum fits in the call's host clock,

plus the drift guard of the port's registry: every family its wired layers
register is documented in the README.
"""
import pathlib
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.distribution_device import init_state, make_sharded_distribute_one
from repro_torch.graph.generators import random_dag
from repro_torch.obs import metrics, trace

TIMED = ("build.prune", "build.bfs_step", "build.append")


@pytest.fixture
def tracer():
    """The process tracer, on and empty, its annotations off again after."""
    was = obs.enabled()
    obs.enable()
    trace.TRACER.clear()
    yield trace.TRACER
    trace.TRACER.profiler_annotations = False
    trace.TRACER.clear()
    if not was:
        obs.disable()


# ----------------------------------------------------------------- the tracer


def _clock_distances_us(tracer, k):
    """|span ts - its record_function's start| of ``k`` annotated spans
    under the profiler, in µs."""
    from torch.profiler import ProfilerActivity, profile

    tracer.clear()
    names = [f"t_obs.clock.{i}" for i in range(k)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("t_obs.clock.warm", annotate=True):
            pass
        for name in names:
            with tracer.span(name, annotate=True):
                torch.ones(8).sum()
    start = {e.name(): e.start_ns() / 1e3 for e in prof.profiler.kineto_results.events()}
    ts = {ev["name"]: ev["ts"] for ev in tracer.events}
    return [abs(ts[name] - start[name]) for name in names]


def test_an_annotated_span_starts_with_its_profiler_range(tracer):
    tracer.profiler_annotations = True
    # a preempted thread can part the two stamps once; three tries
    rounds = [_clock_distances_us(tracer, 20) for _ in range(3)]
    assert min(max(d) for d in rounds) < 100.0, rounds
    # Unix-epoch microseconds, the profiler's epoch
    assert abs(trace._now_us() - time.time_ns() / 1e3) < 1e4


def test_a_full_ring_counts_what_it_drops(tracer):
    t = trace.Tracer(capacity=4)
    for i in range(6):
        with t.span(f"s{i}"):
            pass
    t.event("e")
    assert t.dropped == 3
    assert [ev["name"] for ev in t.events] == ["s3", "s4", "s5", "e"]
    t.clear()
    assert t.dropped == 0 and not t.events


class _Event:
    """A stand-in for a timing ``torch.cuda.Event`` pair's end."""

    def __init__(self, done, ms=0.0):
        self.done, self.ms = done, ms

    def query(self):
        time.sleep(0)   # torch's query lets go of the interpreter lock too
        return self.done

    def elapsed_time(self, end):
        return end.ms


def test_a_cuda_span_without_annotations_is_host_only(tracer):
    """Without annotations a span on a CUDA device records no timing event
    and queries no stream: here, with no card, either would raise."""
    assert not tracer.profiler_annotations
    with tracer.span("t_obs.cuda", device=torch.device("cuda", 0)) as sp:
        pass
    assert sp._stream is None and sp._ev0 is None
    assert not tracer._pending
    assert [ev["name"] for ev in tracer.events] == ["t_obs.cuda"]
    assert "args" not in tracer.events[0]


def test_device_timings_resolve_when_complete_and_clear_drops_them(tracer):
    t = trace.Tracer()
    shared = {"pass": "rev"}
    t._complete("a", "build", 0.0, 1.0, shared, (_Event(True), _Event(True, 2.5)))
    late = _Event(False, 4.0)
    t._complete("b", "build", 1.0, 1.0, None, (_Event(True), late))
    a, b = t.events
    assert a["args"] == {"pass": "rev", "device_ms": 2.5} and shared == {"pass": "rev"}
    assert "args" not in b
    late.done = True
    assert t.chrome_payload()["traceEvents"][1]["args"] == {"device_ms": 4.0}
    t._complete("c", "build", 2.0, 1.0, None, (_Event(True), _Event(False)))
    t.clear()
    assert not t._pending and not t.events


def test_threads_resolving_at_once_lose_no_timing():
    """16 threads resolve one backlog while the interpreter switches threads
    every microsecond: an entry taken off twice, or lost, would show."""
    import sys
    import threading

    k = 20000
    t = trace.Tracer(capacity=k)
    for i in range(k):
        t._complete("s", "build", float(i), 1.0, None, (_Event(True), _Event(True, 1.0)))
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=t.resolve) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(was)
    assert not any(th.is_alive() for th in threads)
    assert not t._pending and len(t.events) == k
    assert all(ev["args"] == {"device_ms": 1.0} for ev in t.events)


# ------------------------------------------------------- the device iteration


def _graph(n=400, m=1200, seed=3):
    g = random_dag(n, m, seed=seed)
    fs, fd = g.edges()
    src, dst = (torch.from_numpy(np.asarray(x, np.int32)) for x in (fs, fd))
    return g, src, dst


def _levels(n, src, dst, source):
    """The levels a plain BFS from ``source`` over (src -> dst) adds."""
    adj = [[] for _ in range(n)]
    for a, b in zip(src.tolist(), dst.tolist()):
        adj[a].append(b)
    seen, frontier, levels = {source}, [source], 0
    while True:
        nxt = {w for u in frontier for w in adj[u]} - seen
        if not nxt:
            return levels
        seen |= nxt
        frontier, levels = sorted(nxt), levels + 1


def _deepest(n, src, dst):
    """A vertex with the most forward levels."""
    return max(range(0, n, 7), key=lambda v: _levels(n, src, dst, v))


def _within(ev, outer):
    return outer["ts"] <= ev["ts"] and ev["ts"] + ev["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("annotations", [False, True])
@pytest.mark.parametrize("max_steps", [64, 2])
def test_one_call_traces_each_part_and_counts_its_steps(tracer, max_steps, annotations):
    tracer.profiler_annotations = annotations
    g, src, dst = _graph()
    n = g.n
    vi = _deepest(n, src, dst)
    fn = make_sharded_distribute_one(None, n, max_steps, "gather")
    traced = fn(init_state(n, 8, device="cpu"), torch.tensor(vi, dtype=torch.int32),
                src, dst, dst, src)
    evs = list(tracer.events)
    assert tracer.dropped == 0
    by = {}
    for ev in evs:
        assert ev["ph"] == "X" and ev["cat"] == "build"
        by.setdefault(ev["name"], []).append(ev)
    assert len(by["build.iteration"]) == 1
    passes = by["build.pass"]
    assert [p["args"]["pass"] for p in passes] == ["rev", "fwd"]
    assert all(_within(p, by["build.iteration"][0]) for p in passes)
    # on the CPU every span is host-only
    assert not any("device_ms" in ev.get("args", {}) for ev in evs)
    want = {"rev": min(_levels(n, dst, src, vi) + 1, max_steps),
            "fwd": min(_levels(n, src, dst, vi) + 1, max_steps)}
    assert max_steps == 64 or want["fwd"] == max_steps   # the cap is reached
    for p in passes:
        inside = {name: [ev for ev in by[name] if _within(ev, p)] for name in TIMED}
        assert len(inside["build.prune"]) == 1 and len(inside["build.append"]) == 1
        steps = inside["build.bfs_step"]
        assert len(steps) == want[p["args"]["pass"]]
        assert inside["build.prune"][0]["ts"] < steps[0]["ts"]
        assert steps[-1]["ts"] < inside["build.append"][0]["ts"]
    assert len(by["build.bfs_step"]) == want["rev"] + want["fwd"]

    obs.disable()
    tracer.clear()
    plain = fn(init_state(n, 8, device="cpu"), torch.tensor(vi, dtype=torch.int32),
               src, dst, dst, src)
    assert not tracer.events and tracer.dropped == 0
    for a, b in zip(traced, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_device_timed_spans_on_the_card(tracer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    g, src, dst = _graph(n=20000, m=60000)
    src, dst = src.to(dev), dst.to(dev)
    n = g.n
    tracer.profiler_annotations = True
    fn = make_sharded_distribute_one(None, n, 64, "gather")
    state = init_state(n, 16, device=dev)
    vis = [torch.tensor(v, dtype=torch.int32, device=dev) for v in range(0, n, n // 4)]
    state = fn(state, vis[0], src, dst, dst, src)     # warm
    torch.cuda.synchronize(dev)
    for vi in vis[1:]:
        tracer.clear()
        t0 = time.perf_counter()
        state = fn(state, vi, src, dst, dst, src)
        torch.cuda.synchronize(dev)
        host_ms = 1e3 * (time.perf_counter() - t0)
        timed = [ev for ev in tracer.events if ev["name"] in TIMED]
        assert {ev["name"] for ev in timed} == set(TIMED)
        assert all(ev["args"]["device_ms"] > 0 for ev in timed)
        assert sum(ev["args"]["device_ms"] for ev in timed) <= host_ms


# ---------------------------------------------------------------- drift guard


def test_every_family_of_the_port_is_documented_in_readme():
    """Importing the port's wired layers registers every production metric
    family; each name must appear (backticked) in README.md."""
    import repro_torch.build.engine        # noqa: F401
    import repro_torch.core.distribution_device  # noqa: F401
    import repro_torch.dynamic.versioned   # noqa: F401
    import repro_torch.ft.inject           # noqa: F401
    import repro_torch.serve.budget        # noqa: F401
    import repro_torch.serve.daemon        # noqa: F401
    import repro_torch.serve.engine        # noqa: F401

    readme = (pathlib.Path(__file__).resolve().parent.parent / "README.md").read_text()
    undocumented = [name for name in metrics.REGISTRY.names()
                    if not name.startswith("t_obs_") and f"`{name}`" not in readme]
    assert not undocumented, f"metric families missing from the README: {undocumented}"
