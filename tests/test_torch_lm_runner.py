"""Slice D through the entry points: ``run_spec`` on ``kind: lm`` specs writes
the reference's record schema; ``launch.train.build_spec`` and the
``lm_smoke`` preset give the reference's run ids; ``qualitative_checks``
gives the reference's ``lm_gossip_spreads`` on the same injected records;
the ``launch.train`` CLI runs on the CPU."""

import argparse

import pytest
import torch

from repro.experiments import analysis as ref_analysis
from repro.experiments import presets as ref_presets
from repro.experiments import runner as ref_runner
from repro.experiments.spec import ExperimentSpec as RefSpec
from repro.experiments.store import ResultsStore as RefStore
from repro.launch import train as ref_train
from repro_torch.experiments import analysis, presets, runner
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.store import ResultsStore
from repro_torch.launch import train


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small operations: one intra-op thread is faster
    for them, and keeps the suite's parallel workers from oversubscribing
    the cores. The worker's setting is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Reduced members (d_model 256, vocab 512), kept quick: 2 rounds, 4 nodes.
LM = dict(topology="ring:n=4", rounds=2, eval_every=1, lr=1e-3,
          model={"kind": "lm", "nodes": 4, "batch": 2, "seq": 16})


@pytest.mark.parametrize("extra", [
    {},
    {"faults": "churn:p_leave=0.3,p_join=0.3"},
    {"model": {**LM["model"], "fused": False, "compress": 0.25}},
])
def test_run_spec_writes_the_reference_schema(tmp_path, extra):
    spec = {**LM, **extra}
    port_spec, ref_spec = ExperimentSpec(**spec), RefSpec(**spec)
    assert port_spec.run_id == ref_spec.run_id
    port_store = ResultsStore(str(tmp_path / "port.jsonl"))
    ref_store = RefStore(str(tmp_path / "ref.jsonl"))
    out = runner.run_spec(port_spec, port_store, device="cpu")
    ref_runner.run_spec(ref_spec, ref_store)
    assert out["status"] == "completed"
    rounds, ref_rounds = port_store.curves(port_spec.run_id), ref_store.curves(ref_spec.run_id)
    assert [r["round"] for r in rounds] == [r["round"] for r in ref_rounds] == [0, 1]
    for a, b in zip(rounds, ref_rounds):
        assert set(a) == set(b)
        assert a["lr"] == pytest.approx(b["lr"], rel=3e-7)
    final = port_store.finals()[port_spec.run_id]["final"]
    ref_final = ref_store.finals()[ref_spec.run_id]["final"]
    assert set(final) == set(ref_final) | {"framework", "device"}
    assert final["framework"] == "torch" and final["device"] == "cpu"
    for key in ("backend", "fused", "compress", "members_m", "graph", "graph_num_periods"):
        assert final[key] == ref_final[key], key
    if "faults" in extra:
        for key in ("faults", "alive_min", "alive_final"):
            assert final[key] == ref_final[key], key


def _cli_ns(**kw):
    ns = dict(arch="llama3.2-1b", steps=100, nodes=4, topology="ring", mix_backend="auto",
              batch=4, seq=128, lr=3e-4, schedule="cosine", gossip_every=1, compress="auto",
              fused=True, faults=None, ckpt_every=0, ckpt_path="results/train_ckpt.npz",
              full_scale=False, resume=False, seed=0)
    ns.update(kw)
    return argparse.Namespace(**ns)


@pytest.mark.parametrize("kw", [
    {},
    {"compress": "none", "fused": False},
    {"compress": "0.25", "resume": True, "ckpt_every": 5},
    {"full_scale": True, "nodes": 2, "steps": 4, "mix_backend": "pallas"},
    {"topology": "ba:n=8,m=2", "nodes": 8, "faults": "churn:p_leave=0.1", "seed": 3},
])
def test_build_spec_gives_the_reference_run_ids(kw):
    assert train.build_spec(_cli_ns(**kw)).run_id == ref_train.build_spec(_cli_ns(**kw)).run_id
    if not kw:
        assert train.build_spec(_cli_ns()).run_id == "ring-iid-s0-37889d7a"


def test_cli_flags_and_defaults_are_the_reference_s():
    """Every reference flag with its default, plus --device."""
    ns = train.parser().parse_args([])
    assert vars(ns) == {**vars(_cli_ns()), "store": "results/torch_train_runs.jsonl",
                        "device": None}
    assert "--lower-only" in train.parser().description


def test_lm_smoke_expands_to_the_reference_run_ids():
    port, ref = presets.get_preset("lm_smoke"), ref_presets.get_preset("lm_smoke")
    assert [s.run_id for s in port] == [s.run_id for s in ref]
    assert len(port) == 6 and all(s.model["kind"] == "lm" for s in port)


@pytest.mark.parametrize("spreads", [(0.30, 0.28, 0.10, 0.12), (0.05, 0.06, 0.20, 0.01)])
def test_qualitative_checks_match_the_reference_on_injected_records(tmp_path, spreads):
    """The lm_smoke runs' records, injected with made-up spreads (two
    gossiped, two isolated), through both packages' join and checks."""
    specs = [s for s in presets.get_preset("lm_smoke") if s.topology == "ring:n=4"]
    gossiped = [s for s in specs if s.gossip_every >= 1]
    isolated = [s for s in specs if s.gossip_every == 0]
    stores = ResultsStore(str(tmp_path / "p.jsonl")), RefStore(str(tmp_path / "r.jsonl"))
    for spec, spread in zip(gossiped + isolated, spreads):
        for store in stores:
            store.run_start(spec.run_id, spec.to_json())
            for r in range(2):
                store.round(spec.run_id, {"round": r, "loss": 5.0 - r,
                                          "g2_token_spread": spread * (r + 1) / 2})
            store.run_end(spec.run_id, "completed", wall_s=1.0, final={
                "round": 1, "loss": 4.0, "g2_token_spread": spread, "consensus_mean": 0.1,
                "graph": {"nodes": 4, "edges": 4}})
    got = analysis.qualitative_checks(analysis.summarize(stores[0]))
    want = ref_analysis.qualitative_checks(ref_analysis.summarize(stores[1]))
    for key in ("lm_gossip_spreads", "lm_gossip_g2_token_spread", "lm_isolated_g2_token_spread"):
        assert got[key] == want[key], key
    assert got["lm_gossip_spreads"] is (spreads[0] + spreads[1] > spreads[2] + spreads[3])


def test_cli_trains_two_steps_on_the_cpu(tmp_path, capsys):
    store = str(tmp_path / "t.jsonl")
    out = train.main(["--steps", "2", "--device", "cpu", "--store", store, "--nodes", "2",
                      "--no-fused", "--compress", "none"])
    assert out["status"] == "completed"
    final = out["final"]
    assert final["fused"] is False and final["compress"] is None and final["round"] == 1
    text = capsys.readouterr().out
    assert "done in" in text and "kernel launches gossip_mix=0" in text
    assert len(ResultsStore(store).curves(out["run_id"])) == 2
