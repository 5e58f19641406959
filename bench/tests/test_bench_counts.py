"""The yardstick's counts equal hand counts for both configurations: the
parameters a node, the nonzeros of W, the local steps a round, and the
operations and bytes that ``round_mfu`` and ``mix_roofline_pct`` divide by."""

import json

import numpy as np
import pytest

from bench import counts
from bench.inputs import draws, graphs, partition
from bench.kinds import mlp
from conftest import ROOT

CASES = {
    # config, traffic, P (784*512+512 + 512*256+256 + 256*128+128 + 128*10+10;
    # 784*64+64 + 64*10+10), nnz (2 (N - 3) + 2 edges, both ways, plus N), steps
    "paper-mlp": ("ba100-hub.curve", 567_434, 492, 9),
    "largen-mlp64": ("ba4096-hub.1card", 50_890, 20_472, 1),
}


def _load(config: str, traffic: str):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{config}.json").read_text())
    tr = json.loads((ROOT / "bench" / "traffic" / f"{traffic}.json").read_text())
    return cfg, tr


@pytest.mark.parametrize("config", sorted(CASES))
def test_parameters_nonzeros_and_steps(config):
    traffic, p, nnz, steps = CASES[config]
    cfg, tr = _load(config, traffic)
    dims = (cfg["in_dim"], *cfg["hidden"], cfg["num_classes"])
    assert mlp.param_count(dims) == p == cfg["params_per_node"]
    g = graphs.make(tr["topology"])
    assert g.n == cfg["nodes"] and g.nnz == nnz
    # The split's sizes do not depend on the images: labels in equal classes.
    labels = np.repeat(np.arange(cfg["num_classes"]), tr["data"]["train_per_class"])
    parts = partition.split(tr["partitioner"], labels, g, seed=7)
    assert draws.local_steps(np.array([len(q) for q in parts]), tr["batch"]) == steps


def test_flops_and_bytes_by_hand():
    p, n = 567_434, 100
    assert counts.sgd_flops(p, 32, 9, n) == 6 * 567_434 * 32 * 9 * 100
    assert counts.eval_flops(p, 10_000, n) == 1_134_868_000_000
    assert counts.mix_flops(492, p) == 2 * 492 * 567_434
    assert counts.mix_bytes(n, p, 492) == 2 * 100 * 567_434 * 4 + 492 * 8
    assert counts.mix_bytes(4096, 50_890, 20_472) == 2 * 4096 * 50_890 * 4 + 20_472 * 8
    # 20 rounds, 11 evaluations, 20 mixes of the paper cell
    got = counts.window_flops(p=p, batch=32, steps=9, n=n, test=10_000, nnz=492, rounds=20,
                              evals=11, gossip_rounds=20)
    assert got == (20 * counts.sgd_flops(p, 32, 9, n) + 11 * counts.eval_flops(p, 10_000, n)
                   + 20 * counts.mix_flops(492, p))


def test_peaks_table():
    h100 = counts.peaks_for("NVIDIA H100 80GB HBM3")
    assert h100["f32_flops_per_s"] == 67e12 and h100["hbm_bytes_per_s"] == 3.35e12
    assert counts.peaks_for("cpu") is None
