"""Nothing the benchmark runs is JAX or the JAX package ``repro``, compared
by whole top-level names, and nothing under ``bench/`` reads the JAX
package's own benchmarks."""
import ast
import subprocess
import sys

from conftest import ROOT

from bench import harness
from bench.manifest import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# built from parts so that this file's own literals do not match
JAX_BENCH_DIR = "bench" + "marks"
JAX_BENCH_FILE = "BENCH" + "_"


def _sources():
    return [p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts]


def _imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_under_bench_imports_jax_or_the_jax_package():
    seen = set()
    for path in _sources():
        tops = _imported_tops(path)
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        seen |= tops
    assert "repro_torch" in seen      # the port is measured, under its own name


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.foreign_modules() == ["repro"]


def test_a_run_loads_no_jax():
    """Import what a run imports, in a fresh process, and list its modules."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import bench.harness, bench.run\n"
            "from bench.manifest import Manifest\n"
            "import repro_torch.core.distribution_device\n"
            "from bench.manifest import HERE\n"
            "for p in (HERE / 'drivers').glob('*.py'): Manifest.driver(p.stem)\n"
            "for p in (HERE / 'metrics').glob('*.py'): Manifest.reader(p.stem)\n"
            "from bench.harness import foreign_modules; print(foreign_modules())\n"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_nothing_under_bench_reads_the_jax_packages_benchmarks():
    for path in _sources():
        assert JAX_BENCH_DIR not in _imported_tops(path), path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert JAX_BENCH_FILE not in node.value, path
                assert JAX_BENCH_DIR + "/" not in node.value, path
    for path in HERE.rglob("*.json"):
        assert JAX_BENCH_FILE not in path.read_text(), path
