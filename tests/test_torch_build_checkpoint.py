"""Build checkpoints of the port's host batched engines, and across packages.

A ``wave`` or ``speculative`` build of ``repro_torch`` killed at a
wave/chunk boundary (``repro_torch.ft.inject``) resumes from its latest
checkpoint and finishes byte-identical to an uninterrupted run, with the
same speculation counts; several crashes stack; a corrupt or foreign
checkpoint is skipped with a warning.  The checkpoint format is the JAX
package's byte for byte: a build killed in ``repro`` resumes in
``repro_torch`` and the reverse, the fingerprints are equal strings, and a
``save_blocks`` snapshot written by one package loads in the other.
"""
import os
import warnings

import numpy as np
import pytest

import repro.build.engine as jengine
import repro.core.order as jorder
import repro.ft.inject as jinject
import repro.persist.blocks as jblocks
import repro_torch.build.engine as tengine
import repro_torch.ft.inject as tinject
import repro_torch.graph.csr as tcsr
import repro_torch.persist.blocks as tblocks
from repro.graph.generators import random_dag
from repro_torch.core.order import get_order
from repro_torch.launch import serve as tserve
from test_build_engine import _dag_families

pytestmark = pytest.mark.chaos

FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")
FAMILIES = _dag_families(np.random.default_rng(0))
PKG = {
    "repro": (jengine, jinject, lambda g: g),
    "repro_torch": (tengine, tinject,
                    lambda g: tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())),
}


def _random_port(seed):
    g = random_dag(300, 1200, seed=seed)
    return tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())


def _assert_same(want, got, tag=""):
    for f in FIELDS:
        assert getattr(want, f).tobytes() == getattr(got, f).tobytes(), (tag, f)
    if "speculation" in want.build_stats:
        ws, gs = want.build_stats["speculation"], got.build_stats["speculation"]
        for k, v in ws.items():
            if not k.endswith("_seconds"):
                assert gs[k] == v, (tag, k, gs[k], v)


def _crash(pkg, g, impl, rules, d, every=1):
    """Run a checkpointed build of ``pkg`` under ``rules``; True when the
    injection fired and killed it."""
    engine, inject, conv = PKG[pkg]
    try:
        with inject.active(inject.Injector(rules)):
            engine.build_distribution_labels(conv(g), impl=impl, checkpoint_dir=str(d),
                                             checkpoint_every=every)
    except inject.SimulatedFailure:
        return True
    return False


def _resume(pkg, g, impl, d, every=1):
    engine, _, conv = PKG[pkg]
    return engine.build_distribution_labels(conv(g), impl=impl, checkpoint_dir=str(d),
                                            checkpoint_every=every)


@pytest.mark.parametrize("name,g", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_wave_kill_and_resume(name, g, tmp_path):
    want = tengine.build_distribution_labels(PKG["repro_torch"][2](g), impl="wave")
    assert _crash("repro_torch", g, "wave", {"build.wave": 2}, tmp_path), \
        "the injection never fired"
    got = _resume("repro_torch", g, "wave", tmp_path)
    _assert_same(want, got, name)
    assert got.build_stats["checkpoint"]["resumed_from"] == 2


@pytest.mark.parametrize("site,at", [("build.chunk", 0), ("build.chunk", 1),
                                     ("build.spec_replay", 0)])
@pytest.mark.parametrize("name,g", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_speculative_kill_and_resume(name, g, site, at, tmp_path):
    """Killed before the first or the second optimistic chunk, or between a
    chunk's watermark rollback and its surviving re-append (the store has
    lost the chunk's appends; resume replays from the last boundary).  Each
    package's kill fires at the same point and its resume starts from the
    same checkpoint; the labels and counts equal an uninterrupted run's."""
    want = tengine.build_distribution_labels(PKG["repro_torch"][2](g), impl="speculative")
    resumed = {}
    for pkg in PKG:
        d = tmp_path / pkg
        if _crash(pkg, g, "speculative", {site: at}, d):
            got = _resume(pkg, g, "speculative", d)
            _assert_same(want, got, f"{name} {pkg}")
            resumed[pkg] = got.build_stats["checkpoint"]["resumed_from"]
    spec = want.build_stats["speculation"]
    if site == "build.chunk":
        # every family has a first chunk; the second is resumed from the
        # checkpoint the first left (every family but the 6-vertex one has two)
        fires = spec["spec_waves"] > at
    else:
        # every family's first chunk has a violation to replay, as
        # tests/test_chaos.py holds for the JAX package
        fires = spec["violations"] > 0
        assert fires, f"{name}: no replay — the test would exercise nothing"
    assert set(resumed) == (set(PKG) if fires else set()), resumed
    assert len(set(resumed.values())) <= 1, resumed
    if fires and site == "build.chunk":
        assert resumed["repro_torch"] == (at or None)


def test_resume_after_multiple_crashes(tmp_path):
    g = _random_port(7)
    for impl, site, at in (("wave", "build.wave", (3, 9)),
                           ("speculative", "build.chunk", (2, 5))):
        want = tengine.build_distribution_labels(g, impl=impl)
        d = tmp_path / impl
        for k in at:
            with pytest.raises(tinject.SimulatedFailure):
                with tinject.active(tinject.Injector({site: k})):
                    tengine.build_distribution_labels(g, impl=impl, checkpoint_dir=str(d),
                                                      checkpoint_every=1)
        got = tengine.build_distribution_labels(g, impl=impl, checkpoint_dir=str(d),
                                                checkpoint_every=1)
        # occurrence counting restarts on resume, so the second crash lands
        # past the first in absolute terms — the checkpoints stack
        assert got.build_stats["checkpoint"]["resumed_from"] >= at[1], impl
        _assert_same(want, got, impl)


@pytest.mark.parametrize("impl,site", [("wave", "build.wave"), ("speculative", "build.chunk")])
def test_resume_dir_reads_one_directory_and_writes_another(impl, site, tmp_path):
    """``resume_dir=A, checkpoint_dir=B``: the build resumes from A's newest
    checkpoint, writes its own checkpoints to B only and leaves A as it was."""
    g = _random_port(7)
    want = tengine.build_distribution_labels(g, impl=impl)
    a, b = tmp_path / "a", tmp_path / "b"
    with pytest.raises(tinject.SimulatedFailure):
        with tinject.active(tinject.Injector({site: 4})):
            tengine.build_distribution_labels(g, impl=impl, checkpoint_dir=str(a),
                                              checkpoint_every=2)
    kept = {p.name: sorted(q.name for q in p.iterdir()) for p in a.iterdir()}
    assert sorted(kept) == ["ckpt_00000002", "ckpt_00000004"], kept
    got = tengine.build_distribution_labels(g, impl=impl, resume_dir=str(a),
                                            checkpoint_dir=str(b), checkpoint_every=2)
    _assert_same(want, got, impl)
    ck = got.build_stats["checkpoint"]
    assert ck["resumed_from"] == 4 and ck["written"] >= 1, ck
    assert {p.name: sorted(q.name for q in p.iterdir()) for p in a.iterdir()} == kept
    written = sorted(p.name for p in b.iterdir())
    assert written and all(int(w[5:]) > 4 for w in written), written


def test_corrupt_checkpoint_is_skipped(tmp_path):
    g = _random_port(7)
    want = tengine.build_distribution_labels(g, impl="wave")
    with pytest.raises(tinject.SimulatedFailure):
        with tinject.active(tinject.Injector({"build.wave": 6})):
            tengine.build_distribution_labels(g, impl="wave", checkpoint_dir=str(tmp_path),
                                              checkpoint_every=2)
    kept = sorted(os.listdir(tmp_path))
    assert kept == ["ckpt_00000004", "ckpt_00000006"], kept
    tinject.flip_bit(str(tmp_path / kept[-1] / "store_mat.npy"), seed=3)
    with pytest.warns(UserWarning, match="skipping unusable checkpoint"):
        got = tengine.build_distribution_labels(g, impl="wave", checkpoint_dir=str(tmp_path),
                                                checkpoint_every=2)
    assert got.build_stats["checkpoint"]["resumed_from"] == 4
    _assert_same(want, got, "corrupt newest")


def test_foreign_checkpoint_is_skipped(tmp_path):
    a, b = _random_port(7), _random_port(8)
    tengine.build_distribution_labels(a, impl="wave", checkpoint_dir=str(tmp_path),
                                      checkpoint_every=4)
    with pytest.warns(UserWarning, match="does not match this build"):
        got = tengine.build_distribution_labels(b, impl="wave", checkpoint_dir=str(tmp_path),
                                                checkpoint_every=4)
    assert got.build_stats["checkpoint"]["resumed_from"] is None
    _assert_same(tengine.build_distribution_labels(b, impl="wave"), got, "foreign")


@pytest.mark.parametrize("impl,site", [("wave", "build.wave"), ("speculative", "build.chunk")])
@pytest.mark.parametrize("killed,resumed", [("repro", "repro_torch"), ("repro_torch", "repro")])
def test_resume_across_packages(killed, resumed, impl, site, tmp_path):
    g = random_dag(400, 1600, seed=11)
    want = jengine.build_distribution_labels(g, impl=impl)
    tg = PKG["repro_torch"][2](g)
    fp_j = jengine._build_fingerprint(g, jorder.get_order(g, "degree_product"), 256, "onepass")
    fp_t = tengine._build_fingerprint(tg, get_order(tg, "degree_product"), 256, "onepass")
    assert fp_j == fp_t
    assert _crash(killed, g, impl, {site: 5}, tmp_path), "the injection never fired"
    got = _resume(resumed, g, impl, tmp_path)
    assert got.build_stats["checkpoint"]["resumed_from"] >= 5
    _assert_same(want, got, f"{killed} -> {resumed}")


@pytest.mark.parametrize("writer,reader", [(jblocks, tblocks), (tblocks, jblocks)],
                         ids=["repro_to_torch", "torch_to_repro"])
def test_snapshot_loads_in_the_other_package(writer, reader, tmp_path):
    rng = np.random.default_rng(2)
    vals, offs = writer.pack_ragged([[1, 2, 3], [], [7]])
    arrays = {"mat": rng.integers(0, 99, (5, 8)).astype(np.int32),
              "mask": rng.integers(0, 2**63, (4, 2), dtype=np.uint64),
              "vals": vals, "offs": offs}
    meta = {"impl": "speculative", "st": {"violations": 3, "rate": 0.25,
                                          "scalar_bailout": False}}
    path = writer.save_blocks(str(tmp_path / "snap"), arrays, meta)
    got, got_meta, bad = reader.load_blocks(path)
    assert not bad and got_meta == meta == reader.snapshot_meta(path)
    for k, a in arrays.items():
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k
    assert reader.unpack_ragged(got["vals"], got["offs"]) == [[1, 2, 3], [], [7]]
    # the same input gives the same bytes on disk from either writer
    path2 = reader.save_blocks(str(tmp_path / "snap2"), arrays, meta)
    assert sorted(os.listdir(path)) == sorted(os.listdir(path2))
    for name in os.listdir(path):
        assert ((tmp_path / "snap" / name).read_bytes()
                == (tmp_path / "snap2" / name).read_bytes()), name
    tinject.flip_bit(os.path.join(path, "mat.npy"), seed=1)
    with pytest.raises(reader.CorruptSnapshotError, match="crc mismatch"):
        reader.load_blocks(path)


def test_checkpoint_warns_for_engines_without_one(tmp_path):
    g = tcsr.from_edges(6, [0, 1, 2, 3], [1, 2, 3, 4])
    for impl, kw in (("reference", {}), ("device", {"device": "cpu"})):
        with pytest.warns(UserWarning, match="host-batched only"):
            o = tengine.build_distribution_labels(g, impl=impl, checkpoint_dir=str(tmp_path),
                                                  **kw)
        assert o.build_stats["impl"] == impl and "checkpoint" not in o.build_stats


def test_restored_impl_wins_with_a_warning(tmp_path):
    g = _random_port(7)
    with pytest.raises(tinject.SimulatedFailure):
        with tinject.active(tinject.Injector({"build.chunk": 3})):
            tengine.build_distribution_labels(g, impl="speculative",
                                              checkpoint_dir=str(tmp_path), checkpoint_every=1)
    with pytest.warns(UserWarning, match="resuming from a 'speculative' checkpoint"):
        got = tengine.build_distribution_labels(g, impl="wave", checkpoint_dir=str(tmp_path))
    assert got.build_stats["impl"] == "speculative"
    assert got.build_stats["checkpoint"]["resumed_from"] >= 3
    _assert_same(tengine.build_distribution_labels(g, impl="speculative"), got, "impl wins")


def test_serve_driver_checkpoint_flags(tmp_path, capsys):
    argv = ["--device", "cpu", "--dataset", "citeseer", "--scale", "0.01",
            "--n-queries", "500", "--backend", "host",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "8"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tserve.main(argv)
        first = capsys.readouterr().out
        tserve.main(argv)
        second = capsys.readouterr().out
    assert "checkpoints: resumed_from=None written=" in first, first
    line = [ln for ln in second.splitlines() if ln.startswith("checkpoints:")]
    assert line and "resumed_from=None" not in line[0], second
