"""A cell is data: a new traffic file, and a cell in the manifest that
names it, run through the harness with no edit to its code."""

import json
import shutil

import torch

from bench import harness
from bench.inputs import make_inputs
from bench.kinds import mlp
from conftest import ROOT


def test_new_traffic_file_is_found_by_name(tmp_path):
    (tmp_path / "bench" / "traffic").mkdir(parents=True)
    (tmp_path / "bench" / "configs").mkdir()
    shutil.copy(ROOT / "bench" / "configs" / "largen-mlp64.json", tmp_path / "bench" / "configs")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({
        "name": "largen-ws24-iid.test", "config": "largen-mlp64", "traffic": "ws24-iid.test",
        "chips": 1, "why": "a small Watts-Strogatz graph with an iid split",
    })
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    (tmp_path / "bench" / "traffic" / "ws24-iid.test.json").write_text(json.dumps({
        "topology": {"family": "ws", "n": 24, "k": 4, "beta": 0.2, "seed": 3},
        "partitioner": "iid", "data": {"train_per_class": 48, "test_per_class": 5},
        "batch": 4, "rounds_per_call": 2, "eval_every": 1, "check_round": 1,
        "backend": "sparse",
    }))
    cell = harness.load_cell("largen-ws24-iid.test", root=tmp_path)
    assert cell.traffic["topology"]["family"] == "ws" and cell.chips == 1
    assert "halo_mib" not in cell.per_layer  # named for the four-card cell only
    cpu = torch.device("cpu")
    inputs = make_inputs(cell.config, cell.traffic, 5, cpu)
    assert inputs.graph.n == 24 and inputs.steps == max(1, int(480 / 24) // 4)
    run = mlp.Run(cell, inputs, [cpu])
    assert run.trainer.mix_impl == "sparse" and [e["round"] for e in run.prog.evals] == [0, 1]
