"""The arithmetic of each metric: the union of busy intervals and the idle
gaps, the device time by operation, and the readers on a hand-made run."""
import types

import pytest

from bench import profiling
from bench.manifest import Manifest


def test_union_and_gaps():
    iv = [(1, 3), (2, 4), (6, 7), (6.5, 6.8), (9, 12)]
    assert profiling.union_length(iv, 0, 10) == pytest.approx(5.0)
    assert profiling.idle_gaps(iv, 0, 10) == [(0, 1), (4, 6), (7, 9)]
    assert profiling.idle_gaps([], 0, 2) == [(0, 2)]


def test_idle_time_goes_to_the_innermost_host_event():
    host = [(0, 10, "outer"), (1, 3, "a"), (2, 2.5, "b"), (12, 13, "d")]
    t = profiling.Trace((0, 15), [(0.5, 1.5, "k", "kernel"), (2.2, 5.5, "m", "gpu_memcpy")],
                        host)
    assert t.busy_s() == pytest.approx(4.3)
    got = dict(t.idle_by_host())
    assert got == pytest.approx({"outer": 5.0, "(no host op)": 4.0, "d": 1.0, "a": 0.5,
                                 "b": 0.2})
    assert sum(got.values()) == pytest.approx(15 - 4.3)


def test_top_device_ops_by_short_name():
    t = profiling.Trace((0, 10), [(0, 1, "void at::native::index_kernel<8>(Args)", "kernel"),
                                  (2, 4, "void at::native::reduce_kernel<512, 1>(R)", "kernel"),
                                  (4, 4.5, "void at::native::index_kernel<4>(Args)", "kernel"),
                                  (5, 5.5, "Memcpy HtoD", "gpu_memcpy")], [])
    assert t.top_device_ops() == [["at::native::reduce_kernel", 2],
                                  ["at::native::index_kernel", 1.5], ["gpu_memcpy", 0.5]]


def _run(**kw):
    base = dict(cell={}, config={}, traffic={}, end_to_end=[], setup_s=1.5, window={},
                spans=[], trace=None, device_kind=None, extra={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_readers_on_a_hand_made_run():
    read = Manifest.reader
    run = _run(window={"seconds": 4.0, "iterations": 6, "call_s": [0.5, 0.7, 0.6]})
    assert read("setup_s")(run) == 1.5
    assert read("vertices_per_s")(run) == 1.5
    assert read("distribute_ms_p50")(run) == pytest.approx(600.0)
    assert read("device_idle_share.build")(run) is None
    assert read("vertices_per_s")(_run(window={"seconds": 4.0, "iterations": 0})) is None
    trace = profiling.Trace((0, 4), [(0, 1, "k(A)", "kernel"), (0.5, 2, "m", "gpu_memset")],
                            [])
    assert read("device_idle_share.build")(_run(trace=trace)) == pytest.approx(50.0)
