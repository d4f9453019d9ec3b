"""Process-global labeled Counter / Gauge / Histogram registry.

One registry for every layer of the serving stack: the daemon's admission
and shed counters, the QueryEngine's degradation ladder, build stage
seconds, dynamic publish totals, and injected-fault counts all register
here, so one ``snapshot()`` (or ``export_json``) answers what five ad-hoc
dicts used to.  The pre-existing surfaces — ``ServeDaemon.health()``,
``QueryEngine.stats()``, ``build_stats``, ``growth_log`` — remain as thin
views; the registry is the shared substrate underneath them.

Design constraints, in order:

  * **cheap on the daemon hot path** — a bound child (``Counter.labels``)
    resolves its label set once at module import; ``inc()`` afterwards is
    an enabled-flag check plus one integer add.  Histograms use fixed
    buckets and ``bisect`` into a preallocated count list — no allocation
    per observation.
  * **consistent snapshots** — ``snapshot()`` takes the registry lock, so
    a reader never sees a metric family mid-registration.  Individual adds
    are unlocked (each bound child is only ever incremented from one
    thread in practice; the GIL keeps the value sane either way).
  * **resettable** — ``reset()`` zeroes every value but keeps every
    instrument and bound child alive, so module-level bound references
    stay valid across bench reps and tests.

Metric naming: ``<layer>_<what>_<unit-or-total>``, labels for the
within-family dimension (``reason``, ``rung``, ``stage``, ``kind``).
Every name registered here must appear in the README metric table — a
tier-1 drift-guard test enforces it.
"""
from __future__ import annotations

import json
import threading
from bisect import bisect_right
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.obs.state import ON

# Default latency buckets (milliseconds): sub-ms dispatches up through the
# multi-second stalls fault injection produces.
LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.5, 1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
)


class _BoundCounter:
    """A counter child bound to one label set; ``inc`` is the hot path."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if ON.enabled:
            self.value += n


class _BoundGauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = None

    def set(self, v) -> None:
        if ON.enabled:
            self.value = v


class _BoundHistogram:
    """Fixed-bucket histogram child: counts[i] = observations <= bounds[i],
    with one overflow slot; ``observe`` allocates nothing."""

    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        if ON.enabled:
            self.counts[bisect_right(self.bounds, v)] += 1
            self.total += v
            self.count += 1


class _Metric:
    """One metric family: a name, a type, and its bound label children."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self.buckets = buckets
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, **labels):
        """Resolve (and cache) the child for one label combination.  Call
        once at module scope and keep the bound child; do not call per
        operation."""
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
        return child

    def _default(self):
        """The unlabeled child (metrics with no labelnames)."""
        return self.labels()

    def _new_child(self):
        if self.kind == "counter":
            return _BoundCounter()
        if self.kind == "gauge":
            return _BoundGauge()
        return _BoundHistogram(self.buckets)

    # unlabeled convenience passthroughs
    def inc(self, n: int = 1) -> None:
        self._default().inc(n)

    def set(self, v) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def value_snapshot(self) -> dict:
        out = {}
        for key, child in self._children.items():
            label = ",".join(f"{k}={v}" for k, v in zip(self.labelnames, key))
            if self.kind == "histogram":
                out[label] = {
                    "buckets_le": list(self.bounds_with_inf()),
                    "counts": list(child.counts),
                    "sum": child.total,
                    "count": child.count,
                }
            else:
                out[label] = child.value
        return out

    def bounds_with_inf(self):
        return tuple(self.buckets) + ("+Inf",)

    def reset_values(self) -> None:
        for child in self._children.values():
            if self.kind == "counter":
                child.value = 0
            elif self.kind == "gauge":
                child.value = None
            else:
                child.counts = [0] * (len(child.bounds) + 1)
                child.total = 0.0
                child.count = 0


class Registry:
    """Name -> metric family; get-or-create semantics so repeated module
    imports (pytest re-imports, multiple daemons) share one family."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, name: str, kind: str, help: str,
                  labelnames: Sequence[str],
                  buckets: Optional[Sequence[float]] = None) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"shape ({m.kind}{m.labelnames} vs {kind}{tuple(labelnames)})")
                return m
            m = _Metric(name, kind, help, tuple(labelnames),
                        None if buckets is None else tuple(buckets))
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Metric:
        return self._register(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Metric:
        return self._register(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS) -> _Metric:
        return self._register(name, "histogram", help, labelnames,
                              buckets=buckets)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        """One consistent dict over every registered family:
        ``{name: {"type", "help", "labels", "values": {label-str: value}}}``."""
        with self._lock:
            fams = list(self._metrics.values())
        return {
            m.name: {
                "type": m.kind,
                "help": m.help,
                "labels": list(m.labelnames),
                "values": m.value_snapshot(),
            }
            for m in sorted(fams, key=lambda m: m.name)
        }

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
            f.write("\n")

    def reset(self) -> None:
        """Zero every value; every instrument and bound child stays alive
        (module-level bound references keep working)."""
        with self._lock:
            for m in self._metrics.values():
                m.reset_values()

    # small read helpers for tests / reconciliation
    def counter_value(self, name: str, **labels) -> int:
        m = self._metrics[name]
        key = tuple(str(labels[k]) for k in m.labelnames)
        child = m._children.get(key)
        return 0 if child is None else int(child.value)

    def counter_total(self, name: str) -> int:
        m = self._metrics[name]
        return sum(int(c.value) for c in m._children.values())


REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
export_json = REGISTRY.export_json
