"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the result line.

``execute`` is everything of a run but the look for a card, so that the
tests can drive it on the CPU at a small size.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, Optional

from bench import profiling
from bench.manifest import Manifest

# top-level module names the measured process may not hold once the window
# has closed: JAX and the JAX package the port was made from
FOREIGN = ("jax", "jaxlib", "flax", "repro")


class ForeignModules(RuntimeError):
    pass


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    cell: dict
    config: dict
    traffic: dict
    end_to_end: list          # names of the cell's end-to-end metrics
    setup_s: float
    window: dict              # the driver's counts and host-clock samples
    spans: list               # the program's own trace events of the window
    trace: Optional[profiling.Trace]
    device_kind: Optional[str]
    extra: dict               # what the check worked out for the readers


def foreign_modules() -> list:
    """The top-level names of ``FOREIGN`` in ``sys.modules``, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FOREIGN))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def execute(manifest: Manifest, workload: str, seed: int, seconds: float, trace: bool,
            device, t_start: float, log: Callable[[str], None] = _log) -> dict:
    """Run ``workload`` once on ``device``; the result line's object.
    ``t_start`` is the host clock when the process began."""
    import torch

    from repro_torch import obs
    from repro_torch.obs import trace as obs_trace

    cuda = device.type == "cuda"
    cell = manifest.workload(workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    driver = manifest.driver(traffic["driver"])
    # the end-to-end metrics are measured with the program's tracing off
    if trace:
        obs.enable()
    else:
        obs.disable()
    obs_trace.TRACER.profiler_annotations = trace
    t_driver = time.perf_counter()
    state = driver.setup(config, traffic, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"{workload}: set-up {setup_s:.3f} s (imports {t_driver - t_start:.3f} s, the "
        f"driver's {setup_s - (t_driver - t_start):.3f} s); window of {seconds} s")
    obs_trace.TRACER.clear()
    with profiling.profiled(trace, cuda) as prof:
        window = driver.window(state, seconds, profiling.marker(trace))
    spans = [ev for ev in obs_trace.TRACER.events if ev.get("ph") == "X"]
    if hasattr(driver, "summary"):
        log(f"{workload}: {driver.summary(window)}")
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traced = profiling.Trace.from_profiler(prof) if trace else None
    del prof
    gc.collect()
    checks, extra = driver.check(state, trace)
    if cuda:
        torch.cuda.synchronize(device)
    kind = torch.cuda.get_device_name(device) if cuda else None
    run = Run(cell=cell, config=config, traffic=traffic,
              end_to_end=manifest.end_to_end_of(workload), setup_s=setup_s, window=window,
              spans=spans, trace=traced, device_kind=kind, extra=extra)
    metrics = {}
    for entry in manifest.metrics_of(workload, trace):
        value = manifest.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    correct = window["attempted"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type, "kind": kind,
                         "count": cell["chips"], "memory_peak_bytes": memory_peak}}
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s(),
                                window_s=traced.window[1] - traced.window[0])
        result["breakdown"] = {"device_ops": traced.top_device_ops(),
                               "idle_gaps": traced.idle_by_host()}
    result["checks"] = checks
    # modules are never unloaded: what the process holds now it held or
    # loaded once the window had closed
    found = foreign_modules()
    if found:
        raise ForeignModules(f"the process holds {found} after the window")
    return result
