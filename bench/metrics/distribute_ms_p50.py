"""distribute_ms_p50: the median of the benchmark's host clock around each
``distribute_one`` call of the window, each ended by a synchronise."""
import statistics


def read(run):
    calls = run.window.get("call_s")
    return 1e3 * statistics.median(calls) if calls else None
