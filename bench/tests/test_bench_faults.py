"""A whole run on the CPU at a small size, the look for a card skipped, with
the timed path broken underneath: ``correct`` has to come out false for each
fault a cell can have.  The cells run on one card, so no fault leaves out an
exchange between cards."""
import time

import numpy as np
import pytest
import torch

from bench.harness import execute

CPU = torch.device("cpu")


def _run(tiny, cell):
    return execute(tiny, cell, 2**31 + 99, 0.5, False, CPU, time.perf_counter(),
                   log=lambda msg: None)


@pytest.mark.parametrize("cell", ["build_mapped_1M", "build_uniprotenc_150m"])
def test_a_sound_run_is_correct(tiny, cell):
    r = _run(tiny, cell)
    assert r["correct"] and r["attempted"] > 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert list(r)[-1] == "checks"


def _build_fault(kind, orig):
    def make(mesh, n, max_steps, row_extract="gather"):
        fn = orig(mesh, n, max_steps, row_extract)

        def broken(state, vi, *edges):
            if kind == "state_unchanged":
                return state
            out = fn(state, vi, *edges)
            if kind == "answer_altered":
                out.L_out[0, 0] = 7
            elif kind == "half_left_out":
                half = n // 2
                for name in ("L_out", "L_in", "out_len", "in_len"):
                    getattr(out, name)[half:] = getattr(state, name)[half:]
            return out

        return broken

    return make


@pytest.mark.parametrize("cell", ["build_mapped_1M", "build_uniprotenc_150m"])
@pytest.mark.parametrize("kind", ["state_unchanged", "answer_altered", "half_left_out"])
def test_build_faults_are_caught(tiny, monkeypatch, cell, kind):
    from repro_torch.core import distribution_device as dd

    monkeypatch.setattr(dd, "make_sharded_distribute_one",
                        _build_fault(kind, dd.make_sharded_distribute_one))
    r = _run(tiny, cell)
    assert not r["correct"] and r["checks"]["label_entries_differing"]["value"] > 0


def test_a_run_that_builds_nothing_is_not_correct(tiny, monkeypatch):
    from bench.manifest import Manifest

    driver = Manifest.driver("build_prefix")

    def empty_window(state, seconds, mark):
        return dict(driver.window(state, 0.0, mark), attempted=0)

    monkeypatch.setattr(tiny, "driver", lambda name: type("D", (), {
        "setup": staticmethod(driver.setup), "window": staticmethod(empty_window),
        "check": staticmethod(driver.check)}))
    r = _run(tiny, "build_mapped_1M")
    assert not r["correct"]
    assert np.isfinite(r["metrics"]["setup_s"]["value"])
