"""Nothing under ``bench/`` imports JAX, the JAX package or the reference's
``benchmarks`` (judged by the top-level module name whole, so that
``repro_torch`` passes and ``repro`` fails), nor reads ``benchmarks/`` or a
``BENCH_*.json``; the plain reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(BENCH.rglob("*.py"))


def _imports(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    assert not _imports(path) & FORBIDDEN


def test_reference_and_inputs_import_nothing_of_the_program():
    for sub in ("reference", "inputs"):
        for path in (BENCH / sub).rglob("*.py"):
            assert "repro_torch" not in _imports(path), path


def test_no_source_reads_the_reference_benchmarks():
    this = __file__.rsplit("/", 1)[-1]
    for path in SOURCES:
        if path.name == this:
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path


def test_importing_the_harness_loads_no_jax():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import bench.harness, bench.calibrate, bench.faults, bench.kinds.mlp\n"
        "import repro_torch.train.trainer, repro_torch.core.decavg\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro', 'benchmarks'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
