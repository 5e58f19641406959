"""The port's topology study (``examples/torch_topology_study.py``) against
the reference's grid (``benchmarks/paper_experiments.py``) at a small size.

Both run ER (three p around p*), BA (m = 2, 5, 10) and SBM (p_in 0.5, 0.8)
on the same graphs and splits. Every deterministic field agrees: run names,
settings, ``extra``, and each row's round, node, degree, G2 holding and SBM
block exactly; the spectral gap of the final W to 1e-6; Table 1's external
edges exactly. The accuracies come from different initial draws (torch's
generator, not JAX's threefry), so they are held to being finite in [0, 1],
and Table 1's confusion rows to summing to 1 (0 for the dropped classes 8
and 9).
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = dict(nodes=16, train_per_class=40, test_per_class=10, rounds=2, eval_every=1)


def _load(name: str, path: Path):
    """The module at ``path`` (a script outside any package on the path)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod  # dataclasses look their module up here
        spec.loader.exec_module(mod)
    return sys.modules[name]


ref = _load("paper_experiments", ROOT / "benchmarks" / "paper_experiments.py")


def _study():
    return _load("torch_topology_study", ROOT / "examples" / "torch_topology_study.py")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """{experiment: (reference outputs, port outputs, port results dir)}."""
    port = _study()
    ref_dir, port_dir = tmp_path_factory.mktemp("ref"), tmp_path_factory.mktemp("port")
    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "RESULTS_DIR", str(ref_dir))
    mp.setattr(port, "RESULTS_DIR", str(port_dir))
    try:
        out = {}
        for name in ("er_experiments", "ba_experiments", "sbm_experiments"):
            want = getattr(ref, name)(ref.ExpSettings(**SETTINGS))
            got = getattr(port, name)(port.ExpSettings(**SETTINGS), device="cpu")
            out[name] = (want, got)
    finally:
        mp.undo()
    return out, port_dir


def _records(outs):
    return [o[0] for o in outs]


def test_settings_are_the_references():
    port = _study()
    assert port.ExpSettings() == port.ExpSettings(**vars(ref.ExpSettings()))
    assert vars(port.ExpSettings.quick()) == vars(ref.ExpSettings.quick())


@pytest.mark.parametrize("name", ["er_experiments", "ba_experiments", "sbm_experiments"])
def test_deterministic_fields_match_the_reference(grids, name):
    want, got = grids[0][name]
    assert len(got) == len(want) == {"sbm_experiments": 2}.get(name, 6)
    for w, g in zip(_records(want), _records(got)):
        assert g["name"] == w["name"]
        assert g["settings"] == w["settings"]
        assert g["extra"] == w["extra"]
        assert abs(g["spectral_gap"] - w["spectral_gap"]) <= 1e-6, g["name"]
        assert len(g["rows"]) == len(w["rows"]) == SETTINGS["rounds"] * SETTINGS["nodes"]
        for gr, wr in zip(g["rows"], w["rows"]):
            for key in ("round", "node", "degree", "holds_g2", "block"):
                assert gr[key] == wr[key], (g["name"], key)
            assert 0.0 <= gr["acc"] <= 1.0
        for key in ("final_mean_acc", "final_std_acc"):
            assert np.isfinite(g[key]) and 0.0 <= g[key] <= 1.0


def test_table1_matches_the_reference(grids):
    want, got = grids[0]["sbm_experiments"]
    for (_wo, _wcm, wext), (_go, gcm, gext) in zip(want, got):
        assert gext == wext
        assert gcm.shape == (4, 10, 10)
        assert np.isfinite(gcm).all()
        np.testing.assert_allclose(gcm.sum(axis=-1)[:, :8], 1.0, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gcm.sum(axis=-1)[:, 8:], 0.0)


def test_records_written_under_their_names(grids):
    out, port_dir = grids
    names = [o["name"] for outs in out.values() for o in _records(outs[1])]
    assert len(names) == 14
    for name in names:
        rec = json.loads((port_dir / f"{name}.json").read_text())
        assert rec["name"] == name and rec["rows"]
    for o in _records(out["sbm_experiments"][1]):
        table = json.loads((port_dir / f"{o['name']}_table1.json").read_text())
        assert set(table) == {"confusion", "external_edges"}
