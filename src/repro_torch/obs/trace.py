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
CUDA kernels on ``torch.profiler``'s own timeline.  ``ts`` is on the
profiler's clock, Unix-epoch microseconds (``perf_counter_ns`` anchored to
``time.time_ns()`` once at import, so it stays monotonic): a span exported
by ``export_chrome`` lies beside ``prof.export_chrome_trace``'s events.

With annotations on, a span given a CUDA ``device`` also records a pair
of timing ``torch.cuda.Event``s on that device's current stream around its
block; the stream time between them (the card's busy and idle time alike)
lands in the event's ``args["device_ms"]``.  Without annotations, on the
CPU and on ``meta`` tensors the span is host-only.  Resolving a timing
never synchronises: ``resolve()`` fills the timings whose end event has
completed, and the program calls it beside a host read it makes anyway
(after which every earlier event on the stream is complete); reading the
ring (``events``, ``chrome_payload``, ``export_chrome``) resolves too, and
``clear()`` drops what is pending.  A full ring drops its oldest event and
counts it in ``dropped``.

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

# Unix-epoch ns minus perf_counter ns, taken once: a monotonic clock on the
# profiler's epoch
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()


def _now_us() -> float:
    return (time.perf_counter_ns() + _EPOCH_NS) / 1000.0


def _timing_event(stream):
    """A timing ``torch.cuda.Event`` recorded on ``stream`` now."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


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
    __slots__ = ("tracer", "name", "cat", "args", "t0", "_ann", "_stream", "_ev0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[dict], annotate: bool, device=None):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._ann = self._stream = self._ev0 = None
        if annotate and tracer.profiler_annotations:
            import torch

            self._ann = torch.profiler.record_function(name)
        if tracer.profiler_annotations and device is not None and device.type == "cuda":
            import torch

            self._stream = torch.cuda.current_stream(device)

    # The timing events lie outside the profiler's range (no launch comes
    # between them), which costs the host less under the profiler.
    def __enter__(self):
        if self._stream is not None:
            self._ev0 = _timing_event(self._stream)
        if self._ann is not None:
            self._ann.__enter__()
        # stamped as the range opens: the profiler's stamp of its start came
        # microseconds before
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc):
        t1 = _now_us()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        timing = None if self._ev0 is None else (self._ev0, _timing_event(self._stream))
        self.tracer._complete(self.name, self.cat, self.t0, t1 - self.t0,
                              self.args, timing)
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
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        # (event, start, end) of device-timed spans not yet resolved, oldest
        # first; one that falls off keeps no device_ms
        self._pending: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        # the ring, the pending timings and ``dropped`` change together
        self._lock = threading.Lock()
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

    def _append(self, ev: dict, timing=None) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)
            if timing is not None:
                self._pending.append((ev,) + timing)

    def _complete(self, name, cat, ts_us, dur_us, args, timing=None) -> None:
        ev = {"ph": "X", "name": name, "cat": cat or "default", "pid": 0,
              "tid": self._tid(), "ts": ts_us, "dur": dur_us}
        if args:
            ev["args"] = args
        self._append(ev, timing)

    def resolve(self) -> None:
        """Write ``args["device_ms"]`` of each device-timed span whose end
        event has completed, oldest first, up to the first that has not
        (``Event.query``: no synchronise, no host read)."""
        with self._lock:
            pending = self._pending
            while pending:
                ev, start, end = pending[0]
                if not end.query():
                    return
                pending.popleft()
                # a fresh dict: the caller's args may be shared between spans
                ev["args"] = dict(ev.get("args") or {}, device_ms=start.elapsed_time(end))

    @property
    def events(self) -> collections.deque:
        """The ring of completed events, oldest first, device timings that
        have completed resolved."""
        self.resolve()
        return self._ring

    # ------------------------------------------------------------- surface

    def span(self, name: str, cat: str = "", args: Optional[dict] = None,
             annotate: bool = False, device=None):
        """Context manager measuring one complete ("X") event; with
        annotations on and a CUDA ``device`` (a ``torch.device``) also its
        block's stream time."""
        if not ON.enabled:
            return NOOP_SPAN
        return _Span(self, name, cat, args, annotate, device)

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
        self._append(ev)

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
        """Empty the ring, drop the pending device timings, zero ``dropped``."""
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self.dropped = 0


TRACER = Tracer()

span = TRACER.span
event = TRACER.event
begin = TRACER.begin
end = TRACER.end
new_trace_id = TRACER.new_trace_id
export_chrome = TRACER.export_chrome
