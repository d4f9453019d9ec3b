"""Observability layer of the port: metrics registry + span tracing.

    from repro_torch import obs

    obs.metrics.counter("x_total").inc()       # process-global registry
    with obs.trace.span("phase", cat="build"): # bounded Chrome-trace ring
        ...
    obs.metrics.snapshot()                     # one surface over all layers
    obs.trace.export_chrome("t.json")          # open in ui.perfetto.dev

``obs.disable()`` turns the whole layer into a no-op (instrumented hot
paths guard on ``obs.ON.enabled`` before allocating anything).  The
registry and tracer are the port's own; they share nothing with ``repro``'s.
"""
from repro_torch.obs import metrics, trace
from repro_torch.obs.state import ON, disable, enable, enabled

__all__ = ["ON", "disable", "enable", "enabled", "metrics", "trace"]
