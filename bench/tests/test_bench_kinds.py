"""A configuration's kind of run is found by its ``kind``: a toy kind,
brought with its configuration, traffic, limits and cell in a temporary
root, runs through the harness with no file of the harness edited; a kind
with no module stops the run, naming the file it looked for; and the
benchmark's own cells load the ``mlp`` kind."""

import json
import time

import pytest

from bench import harness
from conftest import ROOT

TOY = '''
"""Three plain steps of gradient descent towards the seed's target a call;
the reference takes call 0's steps again, and the program's side carries
the configuration's planted offset."""

import torch

NUMBERS = ("gap", "spare")


class Run:
    rounds_per_call, evals_per_call, gossip_per_call = 3, 0, 0
    trainer, param_count = None, 4

    def __init__(self, cell, seed):
        self.inputs = torch.randn(4, generator=torch.Generator().manual_seed(seed),
                                  dtype=torch.float64)
        self.w = self._steps(torch.zeros(4, dtype=torch.float64))
        self.prog = self.w + cell.config["offset"]

    def _steps(self, w):
        for _ in range(self.rounds_per_call):
            w = w - 0.5 * (w - self.inputs)
        return w

    def call(self, on_round=None):
        self.w = self._steps(self.w)

    def release(self):
        self.w = None

    def compare(self, device):
        ref = self._steps(torch.zeros(4, dtype=torch.float64, device=device))
        return {"gap": float((self.prog - ref).abs().max()), "spare": 0.0}


def setup(cell, seed, devices, lap):
    run = Run(cell, seed)
    lap("toy steps")
    return run
'''


def _root(tmp_path, kind: str, offset: float):
    for sub in ("configs", "traffic", "limits", "kinds"):
        (tmp_path / "bench" / sub).mkdir(parents=True, exist_ok=True)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"] = [{"name": "toy", "source": "a test", "file": "bench/configs/toy.json",
                            "reduced": [], "why": "a test"}]
    manifest["workloads"] = [{"name": "toy.steps", "config": "toy", "traffic": "steps",
                              "chips": 1, "why": "a test"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    (tmp_path / "bench" / "configs" / "toy.json").write_text(
        json.dumps({"name": "toy", "kind": kind, "offset": offset}))
    (tmp_path / "bench" / "traffic" / "steps.json").write_text(json.dumps({"why": "a test"}))
    (tmp_path / "bench" / "limits" / "toy.steps.json").write_text(
        json.dumps({"limits": {"gap": {"limit": 1e-2, "lower": 0.0, "upper": 1.0}}}))
    (tmp_path / "bench" / "kinds" / "toy.py").write_text(TOY)
    return tmp_path


def _run(root):
    return harness.run("toy.steps", seed=2**31 + 5, seconds=0.05, traced=False,
                       t_start=time.perf_counter(), device="cpu", root=root)


@pytest.mark.parametrize("offset,correct", [(1e-3, True), (0.1, False)])
def test_toy_kind_runs_through_the_harness(tmp_path, capsys, offset, correct):
    out = _run(_root(tmp_path, "toy", offset))
    assert out["correct"] is correct
    assert out["checked"] == {"gap": {"value": pytest.approx(offset), "limit": 1e-2}}
    assert out["numbers"]["spare"] == 0.0
    assert out["attempted"] % 3 == 0 and out["attempted"] >= 3
    assert set(out["metrics"]) == {"rounds_per_s", "peak_mem_gib", "setup_s"}
    err = capsys.readouterr().err
    assert "toy steps" in err and "check spare 0.000000e+00 not compared" in err


def test_kind_without_a_module_stops_the_run(tmp_path):
    with pytest.raises(SystemExit, match="bench/kinds/nosuch.py"):
        _run(_root(tmp_path, "nosuch", 0.0))


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_benchmark_cells_load_the_mlp_kind(cell):
    c = harness.load_cell(cell)
    assert c.config["kind"] == "mlp"
    assert harness.load_kind(c).NUMBERS == ("param_change", "momentum", "acc", "g2_spread",
                                            "consensus")
