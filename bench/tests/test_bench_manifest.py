"""``BENCHMARK.json`` keeps to the benchmark's contract: names, units and
lines of the allowed characters and lengths, the keys each entry may have,
bounds in range, and every file a cell is made of present."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_units(section):
    entries = MANIFEST[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - KEYS[section] - ({"workloads"} if section in ("end_to_end", "per_layer")
                                          else set())
        assert not extra and KEYS[section] <= set(e), (e["name"], extra)
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert set(e2e) == {"rounds_per_s", "peak_mem_gib", "setup_s"}
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"], []).append(m["name"])
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists(), m["name"]
    assert [m["workloads"] for m in MANIFEST["per_layer"] if m["name"] == "halo_mib"] == [
        ["largen-ba4096-hub.4card"]]


def _reports(section: str, cell: str) -> set[str]:
    return {m["name"] for m in MANIFEST[section] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_reports_what_its_per_layer_metrics_move(cell):
    """Each cell reports ``setup_s``, another end-to-end metric and a
    per-layer metric, and every per-layer metric it lists moves an
    end-to-end metric that the cell reports."""
    e2e, per_layer = _reports("end_to_end", cell), _reports("per_layer", cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    moves = {m["name"]: m["moves"] for m in MANIFEST["per_layer"]}
    assert {moves[m] for m in per_layer} <= e2e


def test_four_card_rate_is_per_layer():
    """The four-card cell's rate spreads between processes by more than an
    end-to-end bound may allow, so that cell reports it per layer."""
    four = "largen-ba4096-hub.4card"
    assert _reports("end_to_end", four) == {"peak_mem_gib", "setup_s"}
    assert "rounds_per_s.4card" in _reports("per_layer", four)
    assert all("rounds_per_s" in _reports("end_to_end", w["name"])
               for w in MANIFEST["workloads"] if w["name"] != four)


def test_cells_configs_traffic_limits():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = set()
    pairs = set()
    four = 0
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        traffic = json.loads((ROOT / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert "cards" not in traffic  # the cell's chips alone say how many cards
        limits = json.loads((ROOT / "bench" / "limits" / f"{w['name']}.json").read_text())
        for v in limits["limits"].values():
            assert v["lower"] < v["limit"] < v["upper"]
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
