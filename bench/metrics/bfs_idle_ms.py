"""bfs_idle_ms: the device's idle time inside the ``build.bfs_step`` ranges
over the window's iterations.  The ranges are the profiler's own record of
the annotated spans (``run.trace.host``), on the profiler's clock like the
idle gaps."""
from bench import profiling, spans


def read(run):
    n = spans.iterations(run)
    if n is None or run.trace is None:
        return None
    steps = [(a, b) for a, b, name in run.trace.host if name == "build.bfs_step"]
    if not steps:
        return None
    lo, hi = run.trace.window
    gaps = run.trace.gaps()
    # |steps & gaps| = |steps| + |gaps| - |steps | gaps|
    idle = (profiling.union_length(steps, lo, hi) + profiling.union_length(gaps, lo, hi)
            - profiling.union_length(steps + gaps, lo, hi))
    return 1e3 * idle / n
