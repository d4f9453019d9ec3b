"""The port's oracle snapshots, write-ahead log and cold start against
``repro``'s, on the CPU.

  * An oracle snapshot saved by either package loads byte-identical in the
    other, both ways; both packages write the same bytes; after the same
    ``flip_bit`` both loads quarantine the same rows (row block, length
    block) or raise the same error (strict), and a wrong kind is refused.
  * A write-ahead log written by either package replays identically in the
    other, with the same torn-tail truncation and the same refusal of
    mid-log corruption.
  * ``oracle_from_snapshot`` in strict and quarantine modes on the five
    serve-test families gives the JAX engine's verdicts and degradation
    counters, whichever package wrote the snapshot.

The counterparts of ``tests/test_persist.py``'s oracle, WAL and
``LabelEpoch`` tests, and the serve driver's ``--snapshot-dir`` and
``--state-dir`` lifecycles.
"""
import contextlib
import os

import numpy as np
import pytest

import repro.core.api as japi
import repro.ft.inject as jinject
import repro.persist as jpersist
from repro.build.engine import build_distribution_labels as jbuild
from repro.graph.csr import from_edges as jfrom_edges
from repro.graph.generators import random_dag as jrandom_dag
import repro_torch.core.api as tapi
import repro_torch.ft.inject as tinject
import repro_torch.graph.csr as tcsr
import repro_torch.persist as tpersist
from repro_torch.build.engine import build_distribution_labels as tbuild
from repro_torch.persist.wal import KIND_DELETE, KIND_INSERT, RECORD_SIZE
from test_serve_engine import _graph_families, _truth_matrix

FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")
FAMILIES = _graph_families(np.random.default_rng(0))
PACKAGES = {"repro": jpersist, "repro_torch": tpersist}
WAYS = [("repro", "repro_torch"), ("repro_torch", "repro")]
WAY_IDS = ["repro_to_torch", "torch_to_repro"]


def _port_graph(g):
    return tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())


@pytest.fixture(scope="module")
def oracles():
    """The same labels built by each package: {package: ReachabilityOracle}."""
    g = jrandom_dag(130, 420, seed=4)
    return {"repro": jbuild(g, impl="wave"), "repro_torch": tbuild(_port_graph(g), impl="wave")}


def _same_oracle(a, b, what):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), \
            (what, f)


def _same_dir(p1, p2):
    assert sorted(os.listdir(p1)) == sorted(os.listdir(p2))
    for name in os.listdir(p1):
        with open(os.path.join(p1, name), "rb") as f1, open(os.path.join(p2, name), "rb") as f2:
            assert f1.read() == f2.read(), name


# ------------------------------------------------------------------ oracle


@pytest.mark.parametrize("writer,reader", WAYS, ids=WAY_IDS)
def test_oracle_snapshot_loads_byte_identical_in_the_other_package(oracles, writer, reader,
                                                                   tmp_path):
    _same_oracle(oracles["repro"], oracles["repro_torch"], "the two builds")
    p = PACKAGES[writer].save_oracle(str(tmp_path / "w"), oracles[writer], row_block=64)
    got = PACKAGES[reader].load_oracle(p)
    _same_oracle(oracles[writer], got, f"{writer} -> {reader}")
    assert type(got).__module__.startswith(reader + ".")
    # the same labels give the same bytes on disk from either writer
    p2 = PACKAGES[reader].save_oracle(str(tmp_path / "r"), oracles[reader], row_block=64)
    _same_dir(p, p2)


@pytest.mark.parametrize("block,side_rows", [("L_out.00001", ("out", slice(64, 128))),
                                             ("L_in.00002", ("in", slice(128, 130))),
                                             ("in_len", ("in", slice(None))),
                                             ("out_len", ("out", slice(None)))])
@pytest.mark.parametrize("writer,reader", WAYS, ids=WAY_IDS)
def test_corrupt_snapshot_quarantines_the_same_rows(oracles, writer, reader, block, side_rows,
                                                    tmp_path):
    """A corrupt row block quarantines its rows, a corrupt length block the
    whole side; strict loads raise naming the block; both packages' reports
    are equal, and so are the loaded (zero-filled) labels."""
    got = {}
    for pkg, inject in (("repro", jinject), ("repro_torch", tinject)):
        p = PACKAGES[writer].save_oracle(str(tmp_path / pkg), oracles[writer], row_block=64)
        inject.flip_bit(os.path.join(p, f"{block}.npy"), seed=1)
        with pytest.raises(PACKAGES[pkg].CorruptSnapshotError, match=block):
            PACKAGES[pkg].load_oracle(p)
        with pytest.warns(UserWarning):
            got[pkg] = PACKAGES[pkg].load_oracle(p, strict=False)
    (jo, jr), (to, tr) = got["repro"], got["repro_torch"]
    assert tr.bad_blocks == jr.bad_blocks == [block] and not tr.clean
    assert np.array_equal(tr.quarantine_out, jr.quarantine_out)
    assert np.array_equal(tr.quarantine_in, jr.quarantine_in)
    side, rows = side_rows
    want = np.zeros(oracles[writer].n, dtype=bool)
    want[rows] = True
    assert np.array_equal(getattr(tr, f"quarantine_{side}"), want)
    assert not getattr(tr, f"quarantine_{'in' if side == 'out' else 'out'}").any()
    _same_oracle(jo, to, "the zero-filled loads")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_wrong_kind_refused(oracles, pkg, tmp_path):
    persist = PACKAGES[pkg]
    p = persist.save_blocks(str(tmp_path / "other"), {"x": np.arange(3)}, {"kind": "zzz"})
    with pytest.raises(persist.CorruptSnapshotError, match="expected a ReachabilityOracle"):
        persist.load_oracle(p)
    with pytest.raises(persist.CorruptSnapshotError, match="expected a BudgetedOracle"):
        persist.load_budgeted(p)
    p = persist.save_oracle(str(tmp_path / "plain"), oracles[pkg])
    with pytest.raises(persist.CorruptSnapshotError, match="expected a BudgetedOracle"):
        persist.load_budgeted(p)


def test_epoch_snapshots_wait_for_the_dynamic_oracle(tmp_path):
    """``LabelEpoch`` snapshots, ported with the dynamic oracle: an epoch
    saved by either package loads in the other byte for byte (both write
    the same bytes); a corrupt ``comp`` is fatal in both even when not
    strict, a corrupt ``level`` disables the level prefilter in both."""
    import repro.dynamic as jdyn
    import repro_torch.dynamic as tdyn

    rng = np.random.default_rng(3)
    n = 60
    src, dst = rng.integers(0, n, 170), rng.integers(0, n, 170)
    dyns = {"repro": jdyn.DynamicOracle(jfrom_edges(n, src, dst)),
            "repro_torch": tdyn.DynamicOracle(tcsr.from_edges(n, src, dst), device="cpu")}
    for pkg, m in (("repro", jdyn), ("repro_torch", tdyn)):
        dyns[pkg].apply(m.UpdateBatch.of(inserts=[(0, 59), (7, 3)]))
        dyns[pkg].publish()
    kw = {"repro": {}, "repro_torch": {"device": "cpu"}}
    q = rng.integers(0, n, size=(400, 2)).astype(np.int32)
    for writer, reader in WAYS:
        ep = dyns[writer].snapshot()
        p = PACKAGES[writer].save_epoch(str(tmp_path / f"{writer}_{reader}"), ep, row_block=16)
        got = PACKAGES[reader].load_epoch(p, **kw[reader])
        assert type(got).__module__ == f"{reader}.dynamic.versioned"
        assert got.epoch == ep.epoch == 1
        assert got.comp.tobytes() == ep.comp.tobytes()
        assert got.level.tobytes() == ep.level.tobytes()
        _same_oracle(ep.oracle, got.oracle, f"{writer} -> {reader}")
        assert np.array_equal(got.query_batch(q), ep.query_batch(q, device=False))
        p2 = PACKAGES[reader].save_epoch(str(tmp_path / f"again_{writer}"),
                                         dyns[reader].snapshot(), row_block=16)
        _same_dir(p, p2)
    # corruption, read by both packages
    for block in ("comp", "level"):
        p = tpersist.save_epoch(str(tmp_path / block), dyns["repro_torch"].snapshot())
        tinject.flip_bit(os.path.join(p, f"{block}.npy"), seed=5)
        for pkg in PACKAGES:
            if block == "comp":
                with pytest.raises(PACKAGES[pkg].CorruptSnapshotError, match="comp"):
                    PACKAGES[pkg].load_epoch(p, strict=False, **kw[pkg])
            else:
                with pytest.warns(UserWarning, match="level prefilter disabled"):
                    ep, report = PACKAGES[pkg].load_epoch(p, strict=False, **kw[pkg])
                assert ep.level is None and report.bad_blocks == ["level"]
                want = dyns["repro_torch"].snapshot().query_batch(q, device=False)
                assert np.array_equal(ep.query_batch(q, device=False), want)
            with pytest.raises(PACKAGES[pkg].CorruptSnapshotError, match=block):
                PACKAGES[pkg].load_epoch(p, **kw[pkg])
    with pytest.raises(tpersist.CorruptSnapshotError, match="expected a LabelEpoch"):
        tpersist.load_epoch(tpersist.save_oracle(str(tmp_path / "plain"),
                                                 dyns["repro_torch"].snapshot().oracle),
                            device="cpu")


# --------------------------------------------------------------------- WAL


def _write_log(pkg, path):
    w = PACKAGES[pkg].WriteAheadLog(path)
    w.append(KIND_INSERT, 1, 2)
    w.append(KIND_DELETE, 3, 4)
    mark = w.publish_marker(epoch=1)
    w.append(KIND_INSERT, 5, 6)
    w.append(KIND_INSERT, 2**40, -7)
    w.close()
    return mark


def _records(recs):
    return [(r.kind, r.u, r.v, r.seq, r.is_publish) for r in recs]


@pytest.mark.parametrize("writer,reader", WAYS, ids=WAY_IDS)
def test_wal_replays_identically_in_the_other_package(writer, reader, tmp_path):
    paths = {pkg: str(tmp_path / f"{pkg}.wal") for pkg in PACKAGES}
    marks = {pkg: _write_log(pkg, paths[pkg]) for pkg in PACKAGES}
    with open(paths["repro"], "rb") as f1, open(paths["repro_torch"], "rb") as f2:
        assert f1.read() == f2.read()   # the same framing byte for byte
    w = PACKAGES[reader].WriteAheadLog(paths[writer])
    assert w.last_seq == 4
    assert _records(w.replay()) == [(1, 1, 2, 0, False), (0, 3, 4, 1, False),
                                    (2, 1, -1, 2, True), (1, 5, 6, 3, False),
                                    (1, 2**40, -7, 4, False)]
    assert _records(w.replay(after_seq=marks[writer])) == [(1, 5, 6, 3, False),
                                                           (1, 2**40, -7, 4, False)]
    # the reader appends where the writer stopped; the writer replays it
    assert w.append(KIND_DELETE, 8, 9) == 5
    w.close()
    w2 = PACKAGES[writer].WriteAheadLog(paths[writer])
    assert _records(w2.replay())[-1] == (0, 8, 9, 5, False)
    w2.reset()
    assert w2.last_seq == -1 and w2.replay() == [] and os.path.getsize(paths[writer]) == 0
    w2.close()


@pytest.mark.parametrize("writer,reader", WAYS, ids=WAY_IDS)
def test_wal_torn_tail_truncated_the_same_way(writer, reader, tmp_path):
    path = str(tmp_path / "wal.bin")
    _write_log(writer, path)
    with open(path, "ab") as f:   # a crash mid-append: half a record
        f.write(b"\x01garbage")
    with pytest.warns(UserWarning, match="torn tail at record #5"):
        w = PACKAGES[reader].WriteAheadLog(path)
    assert os.path.getsize(path) == 5 * RECORD_SIZE   # the tail physically removed
    assert [r.seq for r in w.replay()] == [0, 1, 2, 3, 4]
    w.append(KIND_INSERT, 7, 8)
    w.close()
    assert PACKAGES[writer].WriteAheadLog(path).replay()[-1].seq == 5


@pytest.mark.parametrize("writer,reader", WAYS, ids=WAY_IDS)
def test_wal_mid_log_corruption_refused_by_both(writer, reader, tmp_path):
    path = str(tmp_path / "wal.bin")
    _write_log(writer, path)
    tinject.flip_bit(path, offset=RECORD_SIZE + 3)   # record #1, good ones follow
    for pkg in (reader, writer):
        with pytest.raises(PACKAGES[pkg].CorruptSnapshotError, match="mid-log corruption"):
            PACKAGES[pkg].WriteAheadLog(path)


# -------------------------------------------------------------- cold start


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """Per family: (name, g, {package: snapshot path of its own build})."""
    out = []
    for name, g in FAMILIES:
        d = tmp_path_factory.mktemp(f"snap_{name}")
        paths = {"repro": jpersist.save_oracle(str(d / "repro"), japi.build_oracle(g).oracle,
                                               row_block=16),
                 "repro_torch": tpersist.save_oracle(
                     str(d / "repro_torch"),
                     tapi.build_oracle(_port_graph(g), device="cpu").oracle, row_block=16)}
        _same_dir(paths["repro"], paths["repro_torch"])
        out.append((name, g, paths))
    return out


def _queries(g, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, g.n, size=(1500, 2)).astype(np.int32)
    diag = np.arange(g.n, dtype=np.int32)
    return np.concatenate([q, np.stack([diag, diag], 1)])


@pytest.mark.parametrize("mode", ["strict", "quarantine"])
@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("fam", range(len(FAMILIES)), ids=[f[0] for f in FAMILIES])
def test_oracle_from_snapshot_matches_jax(snapshots, fam, writer, mode, tmp_path):
    """Cold start from a snapshot of either package, clean or with a corrupt
    row block: strict refuses the corrupt one in both packages; quarantine
    mode serves it with the JAX engine's verdicts and counters on every
    backend, and both equal BFS truth."""
    name, g, paths = snapshots[fam]
    path = paths[writer]
    if mode == "quarantine":
        corrupt = str(tmp_path / "corrupt")
        PACKAGES[writer].save_oracle(corrupt, PACKAGES[writer].load_oracle(path), row_block=16)
        tinject.flip_bit(os.path.join(corrupt, "L_in.00000.npy"), seed=fam)
        with pytest.raises(jpersist.CorruptSnapshotError):
            japi.oracle_from_snapshot(g, corrupt)
        with pytest.raises(tpersist.CorruptSnapshotError):
            tapi.oracle_from_snapshot(_port_graph(g), corrupt, device="cpu")
        path = corrupt
    with pytest.warns(UserWarning) if mode == "quarantine" else contextlib.nullcontext():
        jco = japi.oracle_from_snapshot(g, path, mode=mode)
    with pytest.warns(UserWarning) if mode == "quarantine" else contextlib.nullcontext():
        tco = tapi.oracle_from_snapshot(_port_graph(g), path, mode=mode, device="cpu")
    _same_oracle(jco.oracle, tco.oracle, name)
    js, ts = jco.engine.stats(), tco.engine.stats()
    assert ts["n_quarantined"] == js["n_quarantined"]
    assert (ts["n_quarantined"] > 0) == (mode == "quarantine")
    assert tco.engine.backend == "dense" and tco.engine.device.type == "cpu"
    q = _queries(g, fam)
    truth = _truth_matrix(g.n, *g.edges())[q[:, 0], q[:, 1]]
    for backend in ("host", "dense", "kernel"):
        exp = jco.serve(q, backend=backend)
        got = tco.serve(q, backend=backend)
        assert (got == exp).all() and (got == truth).all(), (name, backend)
        assert tco.engine.stats()["last_batch"] == jco.engine.stats()["last_batch"]
    ts, js = tco.engine.stats(), jco.engine.stats()
    assert ts["degradation"] == js["degradation"]
    if mode == "quarantine" and ts["n_quarantined"] and (
            np.isin(jco.comp[q[:, 1]], np.flatnonzero(jco.engine.quarantine_in))).any():
        assert ts["degradation"]["quarantined"] > 0
    for u, v in q[:100]:
        assert tco.query(int(u), int(v)) == jco.query(int(u), int(v))


def test_oracle_from_snapshot_refuses_a_wrong_graph(snapshots, tmp_path):
    name, g, paths = snapshots[0]
    other = tcsr.from_edges(g.n + 7, [0], [1])
    with pytest.raises(ValueError, match="indexes .* vertices but the graph's condensation has"):
        tapi.oracle_from_snapshot(other, paths["repro"], device="cpu")
    with pytest.raises(ValueError, match="strict|quarantine"):
        tapi.oracle_from_snapshot(_port_graph(g), paths["repro"], mode="lenient", device="cpu")


def test_serve_driver_cold_starts_from_its_snapshot(tmp_path, capsys):
    """``--snapshot-dir``: the first run builds and saves, the second
    cold-starts with the same verdicts; ``--state-dir``: the first run starts
    a durable oracle there, the second recovers it with the same verdicts,
    and a state dir written by ``repro`` recovers too."""
    from repro_torch.launch import serve as tserve

    snap = str(tmp_path / "snap")
    argv = ["--device", "cpu", "--dataset", "kegg", "--scale", "0.2", "--n-queries", "600",
            "--backend", "all", "--snapshot-dir", snap]
    first = tserve.main(argv)
    assert "saved index snapshot" in capsys.readouterr().out
    assert first["lifecycle"] == {"saved_snapshot": snap}
    second = tserve.main(argv + ["--load-mode", "quarantine"])
    assert "cold start from snapshot" in capsys.readouterr().out
    assert second["lifecycle"]["n_quarantined"] == 0
    assert second["label_ints"] == first["label_ints"]
    assert second["tier_widths"] == first["tier_widths"]
    for rec in second["backends"].values():
        assert rec["sample_errors"] == 0 and not any(rec["degradation"].values())
    state = str(tmp_path / "state")
    argv = argv[:-2] + ["--state-dir", state]
    third = tserve.main(argv)
    assert f"durable oracle initialized at {state}" in capsys.readouterr().out
    fourth = tserve.main(argv)
    assert "recovered durable oracle from" in capsys.readouterr().out
    assert fourth["lifecycle"]["epoch"] == 0
    for rec in (third, fourth):
        assert rec["label_ints"] == first["label_ints"]
        for r in rec["backends"].values():
            assert r["sample_errors"] == 0 and not any(r["degradation"].values())
    # a state dir that repro's durable oracle wrote, with a published batch
    # and an acknowledged tail
    import repro.dynamic as jdyn
    from repro.graph.generators import paper_dataset_analogue

    jstate = str(tmp_path / "jstate")
    dur = jdyn.DurableDynamicOracle(paper_dataset_analogue("kegg", scale=0.2),
                                    state_dir=jstate)
    dur.apply(jdyn.UpdateBatch.of(inserts=[(0, 5)]))
    dur.publish()
    dur.apply(jdyn.UpdateBatch.of(deletes=[(0, 5)]))
    del dur
    rec = tserve.main(argv[:-1] + [jstate])
    assert "recovered durable oracle from" in capsys.readouterr().out
    assert rec["lifecycle"]["epoch"] == 2 and rec["lifecycle"]["wal_records_replayed"] > 0


@pytest.mark.parametrize("rows_per_pass", [1, 4, 1 << 14])
def test_pack_ragged_in_passes_equals_repro(rows_per_pass, monkeypatch):
    """``pack_ragged`` packs its rows ``ROWS_PER_PASS`` at a time: the blocks
    equal ``repro``'s byte for byte at any pass size, empty rows, no rows
    and all-empty rows included, and ``unpack_ragged`` gives the rows back."""
    import repro_torch.persist.blocks as tblocks

    monkeypatch.setattr(tblocks, "ROWS_PER_PASS", rows_per_pass)
    rng = np.random.default_rng(11)
    cases = [[rng.integers(-5, 1000, int(k)).tolist() for k in rng.integers(0, 6, 37)],
             [], [[], [], []], [[7]]]
    for rows in cases:
        for dtype in (np.int32, np.int64):
            jv, jo = jpersist.pack_ragged(rows, dtype=dtype)
            tv, to = tpersist.pack_ragged(rows, dtype=dtype)
            assert (jv.dtype, jo.dtype, jv.shape, jo.shape) == (tv.dtype, to.dtype, tv.shape,
                                                                to.shape)
            assert jv.tobytes() == tv.tobytes() and jo.tobytes() == to.tobytes()
            assert tpersist.unpack_ragged(tv, to) == rows
