"""The program's own spans of a run (``Run.spans``), as the build's
per-layer readers read them.

The device iteration (``core/distribution_device.py``) traces
``build.iteration`` a call and, inside it, ``build.prune``, one
``build.bfs_step`` a BFS step and ``build.append``, these three with the
card's stream time of their block in ``args["device_ms"]``: the time
between two CUDA events on the stream, so the card's idle time inside the
block counts too.  A reader gives a mean per iteration over the window, or
nothing where the spans are not whole: a ring that dropped events, or an
untimed run.
"""
from __future__ import annotations

from typing import Optional

ITERATION = "build.iteration"
DEVICE_TIMED = ("build.prune", "build.bfs_step", "build.append")


def iterations(run) -> Optional[int]:
    """The window's iteration count, where it equals the count of
    ``build.iteration`` spans and every device-timed span has its
    ``device_ms``; else None."""
    n = sum(ev["name"] == ITERATION for ev in run.spans)
    if not n or n != run.window.get("iterations"):
        return None
    if any(ev["name"] in DEVICE_TIMED and "device_ms" not in ev.get("args", {})
           for ev in run.spans):
        return None
    return n


def stream_ms_per_iteration(run, name: str) -> Optional[float]:
    """The ``device_ms`` of the window's ``name`` spans over its iterations."""
    n = iterations(run)
    if n is None:
        return None
    return sum(ev["args"]["device_ms"] for ev in run.spans if ev["name"] == name) / n
