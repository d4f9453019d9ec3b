"""The build's per-layer readers (``metrics/*_stream_ms.py``,
``bfs_steps_per_iteration``, ``bfs_idle_ms``) on a hand-made run: the
program's spans with their ``device_ms``, and a profiler trace whose idle
gaps fall partly inside the ``build.bfs_step`` ranges."""
import types

import pytest

from bench import profiling
from bench.manifest import Manifest

BUILD = ("bfs_steps_per_iteration", "prune_stream_ms", "bfs_stream_ms", "append_stream_ms",
         "bfs_idle_ms")


def _run(**kw):
    base = dict(cell={}, config={}, traffic={}, end_to_end=[], setup_s=1.5, window={},
                spans=[], trace=None, device_kind=None, extra={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def _build_spans(iterations, steps=(3, 2), prune=1.5, step=0.25, append=2.0):
    """The program's spans of ``iterations`` calls: a pass each of ``steps``."""
    def ev(name, **args):
        return {"ph": "X", "name": name, "cat": "build", "ts": 0.0, "dur": 1.0,
                "args": args}

    out = []
    for _ in range(iterations):
        out.append(ev("build.iteration"))
        for direction, k in zip(("rev", "fwd"), steps):
            out += [ev("build.pass", **{"pass": direction}), ev("build.prune", device_ms=prune)]
            out += [ev("build.bfs_step", device_ms=step) for _ in range(k)]
            out.append(ev("build.append", device_ms=append))
    return out


def test_build_readers_on_a_hand_made_run():
    read = Manifest.reader
    # idle (1.5, 2) and (5.5, 7); the steps' ranges (1, 3) and (5, 6): 1.0 s inside
    trace = profiling.Trace((0, 10), [(0, 1.5, "k", "kernel"), (2, 5.5, "k", "kernel"),
                                      (7, 10, "k", "kernel")],
                            [(1, 3, "build.bfs_step"), (5, 6, "build.bfs_step"),
                             (6, 7, "build.prune")])
    run = _run(window={"seconds": 10.0, "iterations": 2}, spans=_build_spans(2), trace=trace)
    assert read("bfs_steps_per_iteration")(run) == 5.0
    assert read("prune_stream_ms")(run) == pytest.approx(3.0)
    assert read("bfs_stream_ms")(run) == pytest.approx(1.25)
    assert read("append_stream_ms")(run) == pytest.approx(4.0)
    assert read("bfs_idle_ms")(run) == pytest.approx(500.0)


@pytest.mark.parametrize("name", BUILD)
@pytest.mark.parametrize("fault", ["iteration_missing", "device_ms_absent", "no_spans",
                                   "untraced"])
def test_build_readers_give_nothing_on_spans_not_whole(name, fault):
    spans = _build_spans(3)
    trace = profiling.Trace((0, 4), [(0, 1, "k", "kernel")], [(0.5, 2, "build.bfs_step")])
    if fault == "iteration_missing":
        spans.pop(0)
    elif fault == "device_ms_absent":
        next(ev for ev in spans if ev["name"] == "build.bfs_step")["args"].clear()
    elif fault == "no_spans":
        spans = []
    else:
        trace = None
    run = _run(window={"seconds": 4.0, "iterations": 3}, spans=spans, trace=trace)
    got = Manifest.reader(name)(run)
    if fault == "untraced" and name != "bfs_idle_ms":
        assert got is not None
    else:
        assert got is None
