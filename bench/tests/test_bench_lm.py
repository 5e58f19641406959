"""The ``lm`` kind (``bench/kinds/lm.py``) at a tiny size on the CPU: the
Jamba2-3B cell's traffic and readings with the reduced member (f32, one
period, 48 tokens a member) on weights the benchmark draws: a sound run's
numbers stay under the cell's limits; the control and each planted fault
(the skipped local step, the skipped gossip, the inner norms left out, the
scan's state held in bf16) go over at least one of them; the benchmark's
copies of the token streams and of the member's layout are the program's;
the scan's and the mix's counts of work, the span readers, and the cell's
manifest entries."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from bench import check, harness
from bench.inputs import lm_member, tokens
from bench.kinds import lm
from conftest import ROOT

CELL = "jamba2-3b-star3.s4096"
SEED = 2**31 + 77


def _reduced_cell():
    """The cell with the reduced member's numbers in its configuration."""
    from repro_torch.configs import base as cfgbase

    cfg = cfgbase.get("jamba2-3b").reduced()
    cell = harness.load_cell(CELL, overrides={"seq": 48})
    conf = {**cell.config, "hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.hd,
            "mamba_d_state": cfg.mamba.d_state, "mamba_dt_rank": cfg.mamba.rank(cfg.d_model),
            "num_hidden_layers": cfg.num_layers, "param_dtype": "float32"}
    return dataclasses.replace(cell, config=conf), cfg


@pytest.fixture(scope="module")
def readings():
    """The numbers of one seed with each fault planted (None: sound), and
    the control's."""
    cell, reduced = _reduced_cell()
    was, torch_threads = lm.program_config, torch.get_num_threads()
    lm.program_config = lambda cell: reduced
    torch.set_num_threads(2)
    try:
        cpu = torch.device("cpu")
        out = {}
        for fault in (None, *lm.FAULTS):
            with lm.planted(fault):
                run = lm.Run(cell, SEED, [cpu])
            run.release()
            out[fault] = run.compare(cpu)
            if fault is None:
                out["control"] = {**lm.gaps(lm.reference_side(run, cpu, "fp8"),
                                            lm.reference_side(run, cpu)),
                                  "scan": lm.scan_number(run.scan, cpu, torch.bfloat16)}
    finally:
        lm.program_config = was
        torch.set_num_threads(torch_threads)
    return out


def test_a_sound_run_is_correct(readings):
    correct, checked = check.judge(readings[None], check.load_limits(ROOT, CELL))
    assert correct and set(checked) == set(lm.NUMBERS)


@pytest.mark.parametrize("fault", lm.FAULTS)
def test_each_fault_goes_over_a_limit(readings, fault):
    correct, checked = check.judge(readings[fault], check.load_limits(ROOT, CELL))
    assert not correct, checked


def test_the_control_is_not_correct(readings):
    """The reference one precision below the configuration in the program's
    place (matmuls in float8, the scan's state in bf16)."""
    correct, checked = check.judge(readings["control"], check.load_limits(ROOT, CELL))
    assert not correct, checked


def test_a_run_with_no_scan_recorded_reads_infinity():
    assert lm.scan_number(None, torch.device("cpu")) == float("inf")
    assert not check.judge({"scan": lm.scan_number(None, torch.device("cpu"))},
                           check.load_limits(ROOT, CELL))[0]


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_the_token_copy_draws_the_programs_batches(seed):
    from repro_torch.data import tokens as program_tokens

    want = program_tokens.round_token_slab(3, range(2, 5), 2, 33, 65536, seed=seed)
    got = tokens.round_slab(3, range(2, 5), 2, 33, 65536, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_the_drawn_member_has_the_programs_layout():
    """The configuration file's member, leaf for leaf as the program lays
    out Jamba2-3B (paths, shapes, dtypes), at its published count."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as TF
    from repro_torch.tree import tree_leaves

    cell = harness.load_cell(CELL)
    tree = TF.init_params(0, cfgbase.get("jamba2-3b"), device="meta")
    prog = {p: (tuple(x.shape), x.dtype) for p, x in zip(lm._paths(tree), tree_leaves(tree))}
    shapes = lm_member.shapes(cell.config)
    assert {p: s for p, (s, _) in prog.items()} == shapes
    assert sum(int(np.prod(s)) for s in shapes.values()) == cell.config["params_per_member"]
    ssm = {p for p in shapes if p[-1] in ("a_log", "dt_bias", "d_skip")}
    assert all(d == (torch.float32 if p in ssm else torch.bfloat16) for p, (_, d) in prog.items())


def test_the_drawn_member_is_made_from_the_seed():
    cell, _ = _reduced_cell()
    cpu = torch.device("cpu")
    a, b = (lm_member.init_member(cell.config, SEED, cpu) for _ in range(2))
    c = lm_member.init_member(cell.config, SEED + 1, cpu)
    assert all(torch.equal(a[p], b[p]) for p in a)
    assert not torch.equal(a[("embed",)], c[("embed",)])
    dt = torch.nn.functional.softplus(a[("blocks", "layer0", "mamba", "dt_bias")])
    assert 0.999e-3 <= float(dt.min()) and float(dt.max()) <= 0.1001
    assert torch.equal(a[("blocks", "layer0", "mamba", "dt_norm")],
                       torch.ones_like(a[("blocks", "layer0", "mamba", "dt_norm")]))


def test_the_scans_work_is_counted_from_its_shapes():
    one = lm.scan_counts(1, 4096, 5120, 16)
    assert one["fwd_bytes"] == 4 * (3 * 4096 * 5120 + 2 * 4096 * 16)
    assert one["bwd_ops"] == 26 * 4096 * 5120 * 16
    inputs = lm.Inputs(seed=0, nodes=3, batch=1, seq=4096, vocab=65536, mamba_layers=13,
                       d_inner=5120, d_state=16)
    traffic = harness.load_cell(CELL).traffic
    assert lm.evals_per_call(traffic) == 0  # the window's calls record nothing
    assert lm.evals_per_call({**traffic, "eval_every": 8}) == 2  # rounds 0 and 7
    work = lm.scan_work(inputs, rounds=8, evals=0)
    assert work["ops"] == 3 * 13 * (2 * 8 * one["fwd_ops"] + 8 * one["bwd_ops"])
    assert dataclasses.asdict(inputs)["mamba_layers"] == 13
    assert inputs.tokens_per_round == 3 * 4096


def test_the_mixs_work_is_counted_from_the_members_bytes():
    inputs = lm.Inputs(seed=0, nodes=3, batch=1, seq=4096, vocab=65536, mamba_layers=13,
                       d_inner=5120, d_state=16, params=10, member_bytes=24, nnz=7)
    assert lm.mix_work(inputs) == {"bytes": 2 * 3 * 24 + 8 * 7, "ops": 2 * 7 * 10}
    assert np.count_nonzero(lm._matrix("star:n=3")) == 7


def test_the_span_readers_read_the_span_calls():
    def sp(name, ms, **attrs):
        return types.SimpleNamespace(name=name, ms=ms, attrs=attrs)

    calls = [[sp("fused.program", 1.0), sp("fused.stage", 2.0), sp("piece.eager", 30.0),
              sp("piece.capture", 40.0), sp("piece.capture", 5.0), sp("fused.close", 4.0),
              sp("piece.replay", 7.0, piece="local", device_ms=6.0)],
             [sp("piece.eager", 10.0), sp("piece.capture", 20.0),
              sp("piece.replay", 9.0, piece="local", device_ms=8.0)]]
    ctx = types.SimpleNamespace(_memo={lm._SPANS: calls})
    assert lm.restage_ms(ctx) == (82.0 + 30.0) / 2
    assert lm.captures_per_call(ctx) == 1.5
    assert lm.replay_ms(ctx, "local") == 7.0
    assert lm.restage_ms(types.SimpleNamespace(_memo={lm._SPANS: None})) is None


def test_the_cell_loads_the_lm_kind_and_its_readers():
    cell = harness.load_cell(CELL)
    kind = harness.load_kind(cell)
    assert kind.NUMBERS == ("loss", "momentum", "param_change", "scan")
    assert cell.chips == 1 and cell.config["num_hidden_layers"] == 14
    assert cell.traffic["eval_every"] is None
    assert set(cell.end_to_end) == {"rounds_per_s", "peak_mem_gib", "setup_s"}
    assert {"lm_round_mfu", "lm_local_ms", "lm_mix_ms", "scan_ms", "scan_roofline_pct",
            "lm_restage_ms", "lm_captures_per_call", "lm_mix_roofline_pct",
            "device_idle_pct"} == set(cell.per_layer)
