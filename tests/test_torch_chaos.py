"""The port's chaos driver and its dynamic-oracle fault tests, on the CPU.

  * ``tests/test_chaos.py``'s dynamic-oracle tests, restated for the port:
    a crashed ``DurableDynamicOracle`` recovers as snapshot + WAL replay and
    agrees with an oracle fed the same updates (and with ``repro``'s
    recovery); a corrupt newest snapshot is skipped; a failed publish leaves
    the previous epoch serving and stays retryable.
  * ``python -m repro_torch.launch.chaos --device cpu`` passes every
    scenario, each scenario's report equals ``repro``'s where it is
    deterministic (``build``, ``corrupt``, ``serve``, ``dynamic``), and the
    driver exits nonzero when a scenario fails.
"""
import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import repro.dynamic as jdyn
import repro.launch.chaos as jchaos
import repro_torch.dynamic as tdyn
import repro_torch.graph.csr as tcsr
from repro.graph.csr import from_edges
from repro_torch.ft import inject
from repro_torch.ft.inject import SimulatedFailure
from repro_torch.graph.generators import random_dag
from repro_torch.launch import chaos as tchaos

pytestmark = pytest.mark.chaos

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _structural_batches(pkg, g, rng, k=3, per=8):
    """``tests/test_chaos.py::_structural_batches`` for either package: repeats
    of existing edges deleted and random inserts."""
    batches = []
    src, dst = g.edges()
    for _ in range(k):
        ins = [(int(rng.integers(0, g.n)), int(rng.integers(0, g.n))) for _ in range(per)]
        picks = rng.integers(0, src.shape[0], size=per // 2)
        dels = [(int(src[i]), int(dst[i])) for i in picks]
        batches.append(pkg.UpdateBatch.of(inserts=[(u, v) for u, v in ins if u != v],
                                          deletes=dels))
    return batches


def _cyclic(rng, n=60, m=170):
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    return tcsr.from_edges(n, src, dst), from_edges(n, src, dst)


def test_durable_recovery_agrees_with_fresh_rebuild(rng, tmp_path):
    """Cyclic input: recovery restores the incrementally maintained
    condensation, serves the never-crashed oracle's verdicts, and equals
    ``repro``'s recovery of the same updates."""
    g, jg = _cyclic(rng)
    batches = _structural_batches(tdyn, g, np.random.default_rng(1))
    jbatches = _structural_batches(jdyn, jg, np.random.default_rng(1))
    for pkg, gg, bb, d, kw in ((tdyn, g, batches, tmp_path / "t", {"device": "cpu"}),
                               (jdyn, jg, jbatches, tmp_path / "j", {})):
        dur = pkg.DurableDynamicOracle(gg, state_dir=str(d), **kw)
        dur.apply(bb[0])
        dur.publish()
        dur.apply(bb[1])
        dur.publish()
        dur.apply(bb[2])  # acknowledged, not yet published
        del dur  # crash
    rec = tdyn.DurableDynamicOracle.recover(str(tmp_path / "t"), device="cpu")
    jrec = jdyn.DurableDynamicOracle.recover(str(tmp_path / "j"))
    ref = tdyn.DynamicOracle(g, device="cpu")
    for b in batches:
        ref.apply(b)
    ref.publish()
    assert rec.recovered_records == jrec.recovered_records > 0
    assert rec.epoch == jrec.epoch
    q = rng.integers(0, g.n, size=(2000, 2)).astype(np.int32)
    got = rec.serve(q)
    assert np.array_equal(got, ref.serve(q))
    assert np.array_equal(got, jrec.serve(q))
    for f in ("L_out", "L_in", "hop_rank"):
        assert getattr(rec._base_oracle, f).tobytes() == getattr(jrec._base_oracle, f).tobytes()


def test_durable_recovery_skips_corrupt_snapshot(rng, tmp_path):
    g = random_dag(50, 150, seed=9)
    dur = tdyn.DurableDynamicOracle(g, state_dir=str(tmp_path), device="cpu")
    dur.apply(tdyn.UpdateBatch.of(inserts=[(0, 49), (3, 41)]))
    dur.publish()
    q = rng.integers(0, 50, size=(500, 2)).astype(np.int32)
    want = dur.serve(q)
    del dur
    snaps = sorted(d for d in os.listdir(tmp_path) if d.startswith("snap_"))
    assert len(snaps) == 2
    inject.flip_bit(str(tmp_path / snaps[-1] / "L_out.npy"), seed=2)
    with pytest.warns(UserWarning, match="skipping unusable snapshot"):
        rec = tdyn.DurableDynamicOracle.recover(str(tmp_path), device="cpu")
    assert np.array_equal(rec.serve(q), want)


def test_recovery_without_a_verifiable_snapshot_raises(tmp_path):
    from repro_torch.persist import CorruptSnapshotError

    dur = tdyn.DurableDynamicOracle(random_dag(30, 60, seed=1), state_dir=str(tmp_path),
                                    device="cpu")
    del dur
    snap = [d for d in os.listdir(tmp_path) if d.startswith("snap_")][0]
    inject.flip_bit(str(tmp_path / snap / "L_in.npy"), seed=1)
    with pytest.warns(UserWarning, match="skipping unusable snapshot"):
        with pytest.raises(CorruptSnapshotError, match="no verifiable snapshot"):
            tdyn.DurableDynamicOracle.recover(str(tmp_path), device="cpu")


def test_publish_is_transactional_and_retryable(rng):
    g, _ = _cyclic(rng)
    dyn = tdyn.DynamicOracle(g, device="cpu")
    batch = _structural_batches(tdyn, g, rng, k=1)[0]
    dyn.apply(batch)
    q = rng.integers(0, g.n, size=(1500, 2)).astype(np.int32)
    before = dyn.serve(q)
    with pytest.raises(SimulatedFailure):
        with inject.active(inject.Injector({"dynamic.publish": 0})):
            dyn.publish()
    assert dyn._epoch == 0
    assert np.array_equal(dyn.serve(q), before)
    assert dyn.publish() == 1
    ref = tdyn.DynamicOracle(g, device="cpu")
    ref.apply(batch)
    ref.publish()
    assert np.array_equal(dyn.serve(q), ref.serve(q))


# ------------------------------------------------------------- the driver

# scenarios whose printed report depends on nothing but the seed
DETERMINISTIC = ("build", "corrupt", "serve", "dynamic")


def _run(fn, *args) -> tuple:
    buf = io.StringIO()
    with redirect_stdout(buf):
        ok = fn(*args)
    # temporary directories differ from run to run
    return ok, re.sub(r"/\S*/", "<dir>/", buf.getvalue())


@pytest.mark.parametrize("name", list(tchaos.SCENARIOS))
def test_chaos_scenario_passes(name):
    ok, report = _run(tchaos.SCENARIOS[name], 0, "cpu")
    assert ok, report
    assert "PASS" in report.splitlines()[-1]
    if name in DETERMINISTIC:
        jok, jreport = _run(jchaos.SCENARIOS[name], 0)
        assert jok and report == jreport, (report, jreport)


def test_chaos_budget_splits_its_stalled_phase_under_a_slow_batcher(monkeypatch):
    """The budget scenario's second phase must send its first arrival as a
    stalled batch of its own whatever the timing: with the daemon's batcher
    made slow (a 30 ms window instead of 1 ms, as on a loaded host) a fixed
    sleep before the other nine would let all ten land in one batch; the
    scenario waits for the first dispatch to reach the device instead, and
    passes with every check, at least two batches in that phase among them."""
    from repro_torch.serve import daemon

    real = daemon.DaemonConfig
    monkeypatch.setattr(daemon, "DaemonConfig",
                        lambda **kw: real(**{**kw, "batch_window_ms": 30.0}))
    ok, report = _run(tchaos.SCENARIOS["budget"], 0, "cpu")
    assert ok, report
    assert "'batches_mid_serve': " in report and "PASS" in report.splitlines()[-1]


def test_chaos_scenarios_are_repro_s():
    assert list(tchaos.SCENARIOS) == list(jchaos.SCENARIOS)


def test_chaos_driver_exits_nonzero_on_a_failure(monkeypatch, capsys):
    monkeypatch.setitem(tchaos.SCENARIOS, "corrupt", lambda seed, device: False)

    def boom(seed, device):
        raise RuntimeError("scenario crashed")

    monkeypatch.setitem(tchaos.SCENARIOS, "serve", boom)
    with pytest.raises(SystemExit) as ei:
        tchaos.main(["--device", "cpu", "--scenario", "all"])
    assert ei.value.code == 1
    out = capsys.readouterr().out
    assert "serve: FAIL (unhandled RuntimeError: scenario crashed)" in out
    assert "chaos scenarios FAILED: corrupt, serve" in out


def test_chaos_cli_runs_every_scenario_on_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    met, tr = tmp_path / "m.json", tmp_path / "t.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.chaos", "--device", "cpu",
                        "--metrics-out", str(met), "--trace-out", str(tr)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "all 6 chaos scenarios passed" in r.stdout
    assert met.exists() and tr.exists()
