"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
at a small size, and without ``--device`` ask for the card (raising where
there is none, as every entry point of the port does)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# (script, small-size arguments, a line its output must hold)
EXAMPLES = {
    "torch_quickstart.py": (["--nodes", "10", "--rounds", "2", "--train-per-class", "60",
                             "--test-per-class", "10"], "mean recall on never-seen classes"),
    "torch_serve_decode.py": (["--gen", "4"], "through a 16-slot ring cache"),
    "torch_decentralized_llm.py": (["--steps", "3", "--seq", "16", "--batch", "2"],
                                   "consensus distance across nodes"),
    "torch_topology_study.py": (["--nodes", "16", "--rounds", "1"],
                                "tighter communities hinder spread"),
}


def run(script, args, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, str(ROOT / "examples" / script), *args],
                          capture_output=True, text=True, timeout=600, cwd=tmp_path, env=env)


def test_every_port_example_is_listed():
    assert sorted(p.name for p in (ROOT / "examples").glob("torch_*.py")) == sorted(EXAMPLES)


@pytest.mark.parametrize("script", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(script, tmp_path):
    args, marker = EXAMPLES[script]
    res = run(script, [*args, "--device", "cpu"], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert marker in res.stdout, res.stdout[-3000:]


def test_decentralized_llm_checkpoint_holds_the_cohort(tmp_path):
    path = tmp_path / "ck.npz"
    res = run("torch_decentralized_llm.py",
              ["--steps", "2", "--seq", "16", "--batch", "2", "--device", "cpu", "--ckpt", str(path)],
              tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(path) as z:
        assert z["params/embed"].shape == (4, 8192, 256)  # 4 members
        assert int(z["opt/count"]) == 2  # AdamW steps taken


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is there: it would run")
@pytest.mark.parametrize("script", sorted(EXAMPLES))
def test_example_without_device_asks_for_the_card(script, tmp_path):
    res = run(script, EXAMPLES[script][0], tmp_path)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
