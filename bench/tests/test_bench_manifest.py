"""BENCHMARK.json against the benchmark's contract, and the lookup of every
file it names."""
import json
import re

import pytest
from conftest import ROOT

from bench.manifest import HERE, NAME, UNIT, Manifest

DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["paths"] == ["bench"]
    assert DATA["command"] == ["python3", "bench/run.py"]
    assert all(LINE.match(w) for w in DATA["command"])
    assert (ROOT / DATA["command"][1]).is_file()


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = DATA["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in DATA[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert LINE.match(entry[key]), (entry["name"], key)
    assert len(names) == len(set(names))
    metric_names = [n for is_metric, n in names if is_metric]
    assert len(metric_names) == len(set(metric_names))


def test_entries_have_just_the_contract_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, want in keys.items():
        for entry in DATA[section]:
            assert set(entry) - {"workloads"} == want, entry["name"]


def test_bounds():
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert next(m for m in DATA["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    m = Manifest(ROOT)
    for cell in DATA["workloads"]:
        e2e = m.end_to_end_of(cell["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.metrics_of(cell["name"], trace=True)
        assert cell["chips"] in (1, 4)
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    m = Manifest(ROOT)
    layers = {}
    for metric in DATA["per_layer"]:
        for cell in metric["workloads"]:
            assert metric["moves"] in m.end_to_end_of(cell), (metric["name"], cell)
        layers.setdefault(metric["layer"], []).append(metric["name"])
    assert "device" in layers and "build" in layers


def test_every_file_of_a_cell_is_found_by_name(tiny):
    for cell in [c["name"] for c in tiny.data["workloads"]]:
        _found_by_name(tiny, cell)


def _found_by_name(m, cell):
    entry = m.workload(cell)
    config = m.config(entry["config"])
    assert config["name"] == entry["config"]
    traffic = m.traffic(entry["traffic"])
    driver = m.driver(traffic["driver"])
    for fn in ("setup", "window", "check", "control"):
        assert callable(getattr(driver, fn))
    for metric in m.metrics_of(cell, False) + m.metrics_of(cell, True):
        assert callable(m.reader(metric["name"]))


def test_configs_are_files_under_paths_of_their_own():
    files = [c["file"] for c in DATA["configs"]]
    assert len(files) == len(set(files))
    for entry in DATA["configs"]:
        assert entry["file"].startswith("bench/configs/")
        assert LINE.match(entry["source"])
        assert len(entry["reduced"]) <= 16
        assert all(NAME.match(k) for k in entry["reduced"])
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["name"] == entry["name"] and cfg["assumed"] and cfg["guarantees"]
        assert all(k in cfg for k in entry["reduced"])
    used = {c["config"] for c in DATA["workloads"]}
    assert used == {c["name"] for c in DATA["configs"]}


def test_files_under_paths_are_named_from_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path


def test_one_pair_of_config_and_traffic_a_cell():
    pairs = [(c["config"], c["traffic"]) for c in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(c["chips"] == 4 for c in DATA["workloads"]) <= max(1, len(pairs) // 4)
