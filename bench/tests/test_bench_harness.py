"""Each cell's traffic at a tiny N, on the CPU, through the harness's own
path against the port: the sound program is correct; each fault the cell
can have, planted underneath the timed path, and the control (the
reference in TF32 in the program's place) are not; the run refuses to start
without the cell's cards, and outside a checkout that holds the program."""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench import check, faults, harness, trace
from bench.inputs import make_inputs
from bench.kinds import mlp
from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 987_654_321


def tiny(cell: str) -> dict:
    """The cell's traffic at a tiny N (few rounds, few examples)."""
    if cell.startswith("paper"):
        return {"topology": {"n": 16}, "data": {"train_per_class": 200, "test_per_class": 20},
                "rounds_per_call": 3}
    return {"topology": {"n": 32}, "data": {"train_per_class": 100, "test_per_class": 20},
            "rounds_per_call": 3, "check_round": 2}


def cell_faults(cell: str) -> list[str]:
    """The faults each cell can have; a stale batch row shows only where a
    chunk holds more than one round before the compared one (the curve
    cell's round 2, after the chunk of rounds 1 and 2)."""
    return (["still", "half"] + (["exchange"] if cell.endswith("4card") else [])
            + (["stale"] if cell.endswith(".curve") else []))


def run(cell: str, traced: bool = False) -> dict:
    return harness.run(cell, seed=SEED, seconds=0.2, traced=traced,
                       t_start=time.perf_counter(), device="cpu", overrides=tiny(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, capsys):
    out = run(cell)
    assert out["correct"] is True
    assert list(out)[-1] == "checked" and out["checked"]
    assert set(out["checked"]) == set(check.load_limits(ROOT, cell)) <= set(mlp.NUMBERS)
    assert set(out["metrics"]) == set(harness.load_cell(cell).end_to_end)
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert out["device"]["count"] == harness.load_cell(cell).chips
    err = capsys.readouterr().err.strip().splitlines()
    assert all(line.startswith("check ") for line in err[-len(mlp.NUMBERS):])


# Each cell's five numbers at its tiny size on SEED, with four CPU threads,
# as the harness gave them before the kinds of configuration had modules of
# their own.
NUMBERS_BEFORE = {
    "paper-ba100-hub.curve": (6.063177444915564e-09, 1.691428756480513e-08, 0.0, 0.0,
                              5.2341035358779254e-08),
    "largen-ba4096-hub.1card": (1.3025846764887357e-08, 6.408490166061677e-09, 0.0, 0.0,
                                9.009990067319832e-08),
    "largen-ba4096-hub.4card": (1.3025846764887357e-08, 6.408490166061677e-09, 0.0, 0.0,
                                9.009990067319832e-08),
    "paper-ba100-hub.final": (7.099680941127776e-09, 4.0363017421494116e-09, 0.0, 0.0,
                              5.2341035358779254e-08),
}


@pytest.fixture
def four_threads():
    """The thread count the recorded numbers were taken at: a float64
    norm's sum splits by threads, and the gap of two norms keeps that."""
    was = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        yield
    finally:
        torch.set_num_threads(was)


@pytest.mark.parametrize("cell", CELLS)
def test_numbers_as_before(cell, four_threads):
    got = run(cell)["numbers"]
    assert list(got) == list(mlp.NUMBERS)
    want = dict(zip(mlp.NUMBERS, NUMBERS_BEFORE[cell]))
    assert got == pytest.approx(want, rel=1e-9, abs=0)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_per_layer_counts(cell):
    out = run(cell, traced=True)
    assert out["correct"] is True and "breakdown" in out
    assert {"busy_s", "window_s"} <= set(out["device"])
    # No device figure comes from the CPU: only the program's own count and
    # the four-card cell's rate, which that cell reports per layer.
    four = {"halo_mib", "rounds_per_s.4card"}
    assert set(out["metrics"]) <= four
    assert (set(out["metrics"]) == four) == cell.endswith("4card")


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in cell_faults(c)])
def test_fault_underneath_is_caught(cell, fault):
    with faults.planted(fault):
        out = run(cell)
    assert out["correct"] is False, out["numbers"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in TF32 (its operands rounded to TF32 on the CPU) in
    the program's place, against the reference in float32."""
    c = harness.load_cell(cell, overrides=tiny(cell))
    cpu = torch.device("cpu")
    inputs = make_inputs(c.config, c.traffic, SEED, cpu)
    ref = mlp.reference_side(c, inputs, cpu)
    ctl = mlp.reference_side(c, inputs, cpu, precision="tf32")
    correct, checked = check.judge(mlp.gaps(ctl, ref), check.load_limits(ROOT, cell))
    assert correct is False, checked


@pytest.mark.parametrize("cell", ["paper-ba100-hub.curve", "largen-ba4096-hub.1card"])
def test_perturbed_mix_moves_the_numbers(cell):
    """W one float32 step too large in every entry: where the two sides
    agree to rounding (a tiny N on the CPU) the comparison reads it at ten
    times the sound run or more. At the cells' sizes on the card it stays
    under the limits (PERF.md)."""
    sound = run(cell)["numbers"]
    with faults.planted("wmix"):
        bent = run(cell)["numbers"]
    assert bent["param_change"] > 10 * sound["param_change"]


@pytest.mark.parametrize("cell,evals", [("paper-ba100-hub.curve", 21), ("paper-ba100-hub.final", 2),
                                        ("largen-ba4096-hub.1card", 5)])
def test_evaluations_a_call(cell, evals):
    tr = harness.load_cell(cell).traffic
    got = mlp.evaluated_rounds(tr["rounds_per_call"], tr["eval_every"])
    assert len(got) == evals and tr["check_round"] in got
    assert mlp.records_round(harness.load_cell(cell)) in got


def test_no_card_no_result():
    res = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1"], capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv = ['run.py', '--workload', sys.argv[1], '--seed', '1', "
         "'--seconds', '1']; runpy.run_path('bench/run.py', run_name='__main__')", CELLS[0]],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())


class _Ev:
    def __init__(self, name, dev, start, dur, index=0):
        self._n, self._d, self._s, self._t, self._i = name, dev, start, dur, index

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._s + self._t

    def duration_ns(self):
        return self._t

    def device_index(self):
        return self._i

    def is_async(self):
        return False


def test_trace_summary_busy_gaps_and_capture():
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _Ev(trace.SPAN, cpu, 0, 1000),
        _Ev(trace.SPAN, gpu, 0, 1000),  # the span's mirror: no work
        _Ev("kernel_a", gpu, 100, 200),
        _Ev("kernel_b", gpu, 250, 150),  # overlaps a: busy 100-400
        _Ev("kernel_a", gpu, 900, 50),
        _Ev("aten::mm", cpu, 420, 30),
        _Ev("cudaStreamBeginCapture", cpu, 500, 1),
        _Ev("cudaStreamEndCapture", cpu, 700, 1),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == {0: pytest.approx(350e-9)}
    assert s.device_ops[0] == ["kernel_a", pytest.approx(250e-9)]
    idle = dict(s.idle_gaps)
    assert idle[trace.CAPTURE] == pytest.approx(201e-9)
    assert sum(idle.values()) == pytest.approx(650e-9)
    assert np.isclose(100 * (1 - s.mean_busy_s(1) / s.window_s), 65.0)


class _Stub:
    """The little of a ``Context`` that a reader of derived numbers reads."""

    def __init__(self, cell: str, **kw):
        c = harness.load_cell(cell)
        self.cell = c
        self.inputs = type("I", (), {"graph": type("G", (), {"n": c.config["nodes"],
                                                             "nnz": kw.pop("nnz")})})()
        self.param_count = c.config["params_per_node"]
        self.peaks = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}
        self.__dict__.update(kw)

    def value(self, metric):
        return {"mix_ms": 100.0}[metric]


def test_mix_roofline_spreads_the_bound_over_the_cells_cards():
    """The four-card cell's nodes lie on four cards, each with its own HBM:
    its least mix time is a quarter of the one-card cell's."""
    read = harness._reader("mix_roofline_pct")
    one = read(_Stub("largen-ba4096-hub.1card", nnz=20_472))
    four = read(_Stub("largen-ba4096-hub.4card", nnz=20_472))
    assert one == pytest.approx(100 * (2 * 4096 * 50_890 * 4 + 20_472 * 8) / 3.35e12 / 0.1)
    assert four == pytest.approx(one / 4)


def test_idle_share_is_of_the_untraced_call():
    """The traced call's busy seconds over the window's median untraced
    call; the traced call's own length where its busy time exceeds that."""
    read = harness._reader("device_idle_pct")
    summ = trace.Summary(window_s=8.0, busy_s={0: 1.0, 1: 2.0, 2: 1.0, 3: 0.0},
                         device_ops=[], idle_gaps=[])
    ctx = _Stub("largen-ba4096-hub.4card", nnz=0, trace=summ, window={"median_call_s": 4.0})
    assert read(ctx) == pytest.approx(100 * (1 - 1.0 / 4.0))
    ctx.window = {"median_call_s": 0.5}
    assert read(ctx) == pytest.approx(100 * (1 - 1.0 / 8.0))
    ctx.trace = trace.Summary(window_s=8.0, busy_s={}, device_ops=[], idle_gaps=[])
    assert read(ctx) is None


def test_peak_is_of_set_up_and_the_first_call(monkeypatch):
    """``peak_mem_gib`` is read once the window's first call ends, so it
    does not grow with the number of calls that fit the window;
    ``memory_peak_bytes`` is the whole run's."""
    reads = iter(range(1, 100))
    monkeypatch.setattr(harness, "_peak_bytes", lambda devices: next(reads) * 2**30)
    out = run("paper-ba100-hub.final")
    assert out["metrics"]["peak_mem_gib"]["value"] == 1.0
    assert out["device"]["memory_peak_bytes"] == 2 * 2**30
