"""Span tracer with a bounded ring buffer and Chrome-trace JSON export.

Everything the stack does between "request admitted" and "future resolved"
— and everything a build does between "schedule" and "finalize" — can open
a span here.  Completed spans land in a ``deque(maxlen=...)`` ring of
Chrome trace events (the `Trace Event Format`_ that ``chrome://tracing``
and https://ui.perfetto.dev load directly), so a faulted run exports a
timeline an operator can actually scrub:

  * daemon requests carry a ``trace_id`` from admission through queueing,
    the dispatch tick, the padded device call, and the merge/degradation
    rung to completion; sheds and queue expiries are terminal instant
    events on the same id,
  * build runs emit per-wave / per-chunk spans (schedule, sweep, prune
    gather, speculative certify / rollback / replay, checkpoint write),
  * injected faults (``repro_torch.ft.inject``) log instant events at the exact
    occurrence that stalled or failed.

The tracer is process-global (``TRACER``) like the metrics registry.  When
``obs.disable()`` is active, ``span()`` returns one shared no-op context
manager and ``event()`` returns immediately; hot call sites additionally
guard on ``ON.enabled`` before building args dicts, making the disabled
path allocation-free.

``annotate=True`` spans also enter a ``torch.profiler.record_function``
range (when annotations are switched on via
``TRACER.profiler_annotations = True``), so device spans line up with the
CUDA kernels on ``torch.profiler``'s own timeline.

.. _Trace Event Format:
   https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""
from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from typing import Dict, Optional

from repro_torch.obs.state import ON

_EPOCH_NS = time.perf_counter_ns()


def _now_us() -> float:
    return (time.perf_counter_ns() - _EPOCH_NS) / 1000.0


class _NoopSpan:
    """Shared do-nothing span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def event(self, name, **args):
        pass

    def set(self, **args):
        pass


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("tracer", "name", "cat", "args", "t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[dict], annotate: bool):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._ann = None
        if annotate and tracer.profiler_annotations:
            import torch

            self._ann = torch.profiler.record_function(name)
        self.t0 = _now_us()

    def __enter__(self):
        if self._ann is not None:
            self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self.tracer._complete(self.name, self.cat, self.t0,
                              _now_us() - self.t0, self.args)
        return False

    def event(self, name: str, **args) -> None:
        """Instant event nested inside this span (inherits cat/trace_id)."""
        if self.args and "trace_id" in self.args:
            args.setdefault("trace_id", self.args["trace_id"])
        self.tracer.event(name, cat=self.cat, **args)

    def set(self, **args) -> None:
        """Attach args discovered mid-span (e.g. the rung a dispatch took)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)


class Tracer:
    """Bounded ring of completed Chrome trace events + span factories."""

    def __init__(self, capacity: int = 65536):
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.profiler_annotations = False
        self._trace_ids = itertools.count(1)
        self._tid_map: Dict[int, int] = {}
        self._tid_lock = threading.Lock()

    # ------------------------------------------------------------ plumbing

    def new_trace_id(self) -> int:
        """Monotonic per-process request id, carried through span args."""
        return next(self._trace_ids)

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tid_map.get(ident)
        if tid is None:
            with self._tid_lock:
                tid = self._tid_map.setdefault(ident, len(self._tid_map))
        return tid

    def _complete(self, name, cat, ts_us, dur_us, args) -> None:
        ev = {"ph": "X", "name": name, "cat": cat or "default", "pid": 0,
              "tid": self._tid(), "ts": ts_us, "dur": dur_us}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ------------------------------------------------------------- surface

    def span(self, name: str, cat: str = "", args: Optional[dict] = None,
             annotate: bool = False):
        """Context manager measuring one complete ("X") event."""
        if not ON.enabled:
            return NOOP_SPAN
        return _Span(self, name, cat, args, annotate)

    def begin(self, name: str, cat: str = "", args: Optional[dict] = None):
        """Explicit begin for spans that end in another thread/callback;
        finish with ``end(token)``."""
        if not ON.enabled:
            return None
        return (name, cat, args, _now_us())

    def end(self, token, **extra) -> None:
        if token is None or not ON.enabled:
            return
        name, cat, args, t0 = token
        if extra:
            args = dict(args or {}, **extra)
        self._complete(name, cat, t0, _now_us() - t0, args)

    def event(self, name: str, cat: str = "", **args) -> None:
        """Instant ("i") event — terminal sheds, breaker flips, faults."""
        if not ON.enabled:
            return
        ev = {"ph": "i", "name": name, "cat": cat or "default", "pid": 0,
              "tid": self._tid(), "ts": _now_us(), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -------------------------------------------------------------- export

    def export_chrome(self, path: str, meta: Optional[dict] = None) -> None:
        """Write the ring as a Perfetto/chrome://tracing-loadable JSON file."""
        with open(path, "w") as f:
            json.dump(self.chrome_payload(meta), f)
            f.write("\n")

    def chrome_payload(self, meta: Optional[dict] = None) -> dict:
        payload = {"traceEvents": sorted(self.events, key=lambda e: e["ts"]),
                   "displayTimeUnit": "ms"}
        if meta:
            payload["metadata"] = meta
        return payload

    def clear(self) -> None:
        self.events.clear()


TRACER = Tracer()

span = TRACER.span
event = TRACER.event
begin = TRACER.begin
end = TRACER.end
new_trace_id = TRACER.new_trace_id
export_chrome = TRACER.export_chrome
