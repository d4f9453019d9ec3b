"""The reduction of a ``torch.profiler`` trace to device busy time, idle
gaps and device time by operation.

A traced run profiles its whole window inside one ``record_function``
range named ``WINDOW``; every timestamp is the profiler's own (kineto's
events, in nanoseconds), so host ranges and device intervals share one
clock.  The device is busy while a kernel, a copy or a memset runs on it.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, List, Sequence, Tuple

WINDOW = "bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation")


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool):
    """Profile the block (host and, with ``cuda``, device activity) inside
    the ``WINDOW`` range; yields the profiler, or None when not ``enabled``."""
    if not enabled:
        yield None
        return
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    # the profiler's note that it keeps only the last cycle's events: one cycle here
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield prof
        if cuda:
            torch.cuda.synchronize()


class Trace:
    """The events of one profiled window, as plain tuples in seconds.

    ``device``: (start, end, name, kind) of every device interval;
    ``host``: (start, end, name) of every host operation and range of the
    main thread; ``window``: (start, end) of the ``WINDOW`` range."""

    def __init__(self, window: Tuple[float, float], device: list, host: list):
        self.window = window
        self.device = sorted(device)
        self.host = sorted(host, key=lambda e: (e[0], -e[1]))

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        events = prof.profiler.kineto_results.events()
        window, device, host = None, [], []
        main = None
        for e in events:
            kind = event_kind(e)
            t0 = e.start_ns() * 1e-9
            t1 = t0 + e.duration_ns() * 1e-9
            if kind in DEVICE_KINDS:
                device.append((t0, t1, e.name(), kind))
            elif kind in HOST_KINDS:
                if kind == "user_annotation" and e.name() == WINDOW:
                    window, main = (t0, t1), e.start_thread_id()
                host.append((t0, t1, e.name(), e.start_thread_id()))
        if window is None:
            raise RuntimeError(f"the profiler's trace holds no {WINDOW!r} range")
        host = [(a, b, name) for a, b, name, tid in host if tid == main and name != WINDOW]
        return cls(window, device, host)

    def busy_s(self) -> float:
        """Seconds of the window in which some device interval ran."""
        return union_length([(a, b) for a, b, _, _ in self.device], *self.window)

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's stretches with no device interval, in time order."""
        return idle_gaps([(a, b) for a, b, _, _ in self.device], *self.window)

    def top_device_ops(self, k: int = 10) -> List[list]:
        """The ``k`` device operations that took the most time: [[name, s]]."""
        total = {}
        for a, b, name, kind in self.device:
            key = short_name(name) if kind == "kernel" else kind
            total[key] = total.get(key, 0.0) + (b - a)
        return [[name, s] for name, s in sorted(total.items(), key=lambda x: -x[1])[:k]]

    def idle_by_host(self, k: int = 10) -> List[list]:
        """The window's idle device time by what the host's main thread was
        doing meanwhile (its innermost range or operation, ``"(no host
        op)"`` between them): the ``k`` largest, [[name, s]]."""
        total = {}
        segments = innermost_segments(self.host, *self.window)
        j = 0
        for a, b in self.gaps():
            while j < len(segments) and segments[j][1] <= a:
                j += 1
            i = j
            while i < len(segments) and segments[i][0] < b:
                s0, s1, name = segments[i]
                total[name] = total.get(name, 0.0) + min(b, s1) - max(a, s0)
                i += 1
        return [[name, s] for name, s in sorted(total.items(), key=lambda x: -x[1])[:k]]


def event_kind(e) -> str:
    """A kineto event's activity type: kineto's own name where this torch
    gives it, else worked out from the device it ran on and its name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if str(e.device_type()).endswith("CUDA"):
        if e.is_user_annotation():
            return "gpu_user_annotation"
        name = e.name()
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "user_annotation" if e.is_user_annotation() else "cpu_op"


def short_name(name: str) -> str:
    """A kernel's name without its template and parameter lists."""
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    short = "".join(out).strip()
    short = short.split()[-1] if short else name
    return short[:120]


def merged(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> list:
    """The union of ``intervals`` clipped to [lo, hi], as disjoint sorted
    intervals."""
    out: list = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_length(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` within [lo, hi]."""
    return sum(b - a for a, b in merged(intervals, lo, hi))


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    return gaps


def innermost_segments(host: Sequence[Tuple[float, float, str]], lo: float,
                       hi: float) -> List[Tuple[float, float, str]]:
    """[lo, hi] cut into consecutive segments, each named after the
    innermost of the ``host`` events (sorted by start, outer first; events
    of one thread nest) that covers it, or ``"(no host op)"``."""
    idle = "(no host op)"
    out, stack, t = [], [], lo

    def emit(end: float) -> None:
        nonlocal t
        a, b = max(t, lo), min(end, hi)
        if b > a:
            out.append((a, b, stack[-1][2] if stack else idle))
        t = max(t, end)

    for ev in host:
        while stack and stack[-1][1] <= ev[0]:
            emit(stack[-1][1])
            stack.pop()
        emit(ev[0])
        stack.append(ev)
    while stack:
        emit(stack[-1][1])
        stack.pop()
    emit(hi)
    return out


def marker(enabled: bool):
    """``mark(name)``: a ``record_function`` range named ``name`` on the
    profiler's host timeline when ``enabled``, else a context that does
    nothing."""
    if not enabled:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function
