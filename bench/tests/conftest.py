"""The benchmark's own tests: ``python -m pytest -q bench/tests`` from the
root of the repository.  They run on the CPU at small sizes; the one test
that needs a card is marked ``cuda`` and skips without one."""
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the configurations cut to what a CPU test holds; every other key as committed
TINY = {"mapped_1M": dict(n=3000, m=3017, l_max=16),
        "uniprotenc_150m": dict(n=5000, m=4999, l_max=8)}


@pytest.fixture
def tiny(tmp_path):
    """A ``Manifest`` of the committed cells, metrics, traffic and drivers,
    the configurations cut to ``TINY`` sizes."""
    from bench.manifest import HERE, Manifest

    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in data["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        cfg.update(TINY[entry["name"]])
        entry["file"] = f"{entry['name']}.json"
        (tmp_path / entry["file"]).write_text(json.dumps(cfg))
    return Manifest(tmp_path, data, traffic_dir=HERE / "traffic")
