"""Workload generation for the dynamic oracle (the counterpart of
``repro.dynamic.workload``): for now its open-loop arrival process alone,
which ``serve.openloop`` drives the daemon with; trace generation and
replay come with the dynamic oracle (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

import numpy as np


def poisson_times(rate_per_s: float, duration_s: float,
                  seed: int = 0) -> np.ndarray:
    """Open-loop arrival times: a Poisson process at ``rate_per_s`` over
    ``[0, duration_s)``, as a sorted float64 array of offsets in seconds
    (``repro.dynamic.workload.poisson_times``, draw for draw).

    Open-loop means arrivals are INDEPENDENT of service completions — the
    workload keeps coming whether or not the server keeps up, which is the
    regime that exposes overload behavior (closed-loop drivers self-throttle
    and hide it)."""
    rng = np.random.default_rng(seed)
    rate = max(float(rate_per_s), 1e-9)
    # draw in chunks: E[count] + 5 sigma covers the horizon w.h.p.
    est = int(rate * duration_s + 5 * np.sqrt(rate * duration_s) + 16)
    times = np.cumsum(rng.exponential(1.0 / rate, size=est))
    while times.size and times[-1] < duration_s:
        more = np.cumsum(rng.exponential(1.0 / rate, size=est)) + times[-1]
        times = np.concatenate([times, more])
    return times[times < duration_s]
