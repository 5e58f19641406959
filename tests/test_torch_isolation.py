"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``
or an ``examples/torch_*.py``) imports ``jax`` or anything of ``repro``, and
every entry point asked for the default device raises instead of running on
the CPU when there is no card:
the DecAvg runner and trainer, serving (model init, caches, the Engine, the
serve CLI), and LLM-cohort training and routing (the trainer, the lm
executor, the train CLI, serve-eval, the cohort loader)."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import base as cfgbase
from repro_torch.core.decavg import GossipEngine
from repro_torch.data.loader import NodeLoader
from repro_torch.device import resolve_device
from repro_torch.experiments import runner, sweep
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.store import ResultsStore
from repro_torch.experiments import serve_eval
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as TF
from repro_torch.serve import router
from repro_torch.serve.engine import Engine
from repro_torch.train.trainer import DecentralizedTrainer, LMCohortTrainer

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    ]


def test_importing_every_module_leaves_out_jax_and_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.gossip_mix" in mods and "repro_torch.experiments.sweep" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "examples").glob("torch_*.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_imports_neither_jax_nor_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_the_scan_covers_the_dry_run_and_the_examples():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")}
    scanned |= {p.relative_to(ROOT).as_posix() for p in (ROOT / "examples").glob("torch_*.py")}
    for mod in ("shapes", "analysis", "dryrun"):
        assert f"src/repro_torch/launch/{mod}.py" in scanned
    assert {"examples/torch_quickstart.py", "examples/torch_serve_decode.py",
            "examples/torch_decentralized_llm.py"} <= scanned


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cpu_loader(n=6):
    x = np.zeros((n * 4, 8), np.float32)
    y = np.arange(n * 4) % 2
    parts = [np.arange(4 * i, 4 * i + 4) for i in range(n)]
    return NodeLoader(x, y, parts, batch_size=2, device="cpu")


def _llm():
    return cfgbase.get("llama3.2-1b").reduced()


_ENTRY_POINTS = {
    "resolve_device": lambda tmp: resolve_device(None),
    "GossipEngine": lambda tmp: GossipEngine("ring:n=6"),
    "DecentralizedTrainer": lambda tmp: DecentralizedTrainer(
        "ring:n=6", _cpu_loader(), in_dim=8, num_classes=2
    ),
    "run_spec": lambda tmp: runner.run_spec(
        ExperimentSpec("ring:n=6"), ResultsStore(str(tmp / "r.jsonl"))
    ),
    "run_sweep": lambda tmp: runner.run_sweep([ExperimentSpec("ring:n=6")], str(tmp / "s.jsonl")),
    "sweep_cli": lambda tmp: sweep.main(
        ["--preset", "smoke", "--store", str(tmp / "c.jsonl"), "--bench-out", "", "--quiet"]
    ),
    "init_params": lambda tmp: TF.init_params(0, _llm()),
    "init_cache": lambda tmp: TF.init_cache(_llm(), 2, 8),
    # parameters the caller left on the CPU: the engine still wants the card
    "Engine": lambda tmp: Engine(TF.init_params(0, _llm(), device="cpu"), _llm()),
    "serve_cli": lambda tmp: serve_cli.main([]),
    "LMCohortTrainer": lambda tmp: LMCohortTrainer("ring:n=2", _llm(), nodes=2),
    "train_cli": lambda tmp: train_cli.main(["--steps", "1", "--store", str(tmp / "t.jsonl")]),
    "lm_run_spec": lambda tmp: runner.run_spec(
        ExperimentSpec("ring:n=2", model={"kind": "lm", "nodes": 2}),
        ResultsStore(str(tmp / "lm.jsonl")),
    ),
    "serve_eval": lambda tmp: serve_eval.main(["--rounds", "1"]),
    "load_cohort": lambda tmp: router.load_cohort(str(tmp / "c.npz"), _llm(), nodes=2),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_default_device_without_cuda_raises(name, no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[name](tmp_path)
    # Nothing ran: no store was written on the way to the error.
    assert not list(tmp_path.iterdir())
