"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one its ``configs`` entry gives; the
traffic mix is ``traffic/<traffic>.json``; the mix's ``driver`` is
``drivers/<driver>.py``; a metric's reader is ``metrics/<name>.py``.
Adding a cell, a mix or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_module(path: pathlib.Path, name: str):
    """Import the file ``path`` as a module of its own named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """The parsed ``BENCHMARK.json`` at ``root`` (a checkout's root)."""

    def __init__(self, root: pathlib.Path, data: Optional[dict] = None,
                 traffic_dir: pathlib.Path = HERE / "traffic"):
        self.root = pathlib.Path(root)
        self.data = data if data is not None else json.loads(
            (self.root / "BENCHMARK.json").read_text())
        self.traffic_dir = pathlib.Path(traffic_dir)

    def workload(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")

    def config(self, name: str) -> dict:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"BENCHMARK.json has no config {name!r}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.traffic_dir / f"{name}.json").read_text())

    @staticmethod
    def driver(name: str):
        return load_module(HERE / "drivers" / f"{name}.py", f"bench_driver_{name}")

    def metrics_of(self, cell: str, trace: bool) -> list:
        """The metric entries a run of ``cell`` reports: its end-to-end
        metrics untraced, its per-layer metrics traced."""
        section = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in section if cell in m.get("workloads", [cell])]

    def end_to_end_of(self, cell: str) -> list:
        return [m["name"] for m in self.metrics_of(cell, trace=False)]

    @staticmethod
    def reader(name: str):
        """``metrics/<name>.py``'s ``read``."""
        mod = load_module(HERE / "metrics" / f"{name}.py",
                          "bench_metric_" + name.replace(".", "_").replace("-", "_"))
        return mod.read
