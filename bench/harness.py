"""One run of one cell: set-up, the timed window, the per-layer readings of a
traced run, and the comparison with the plain reference.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file the manifest names, its
traffic in ``bench/traffic/<traffic>.json``, its per-layer metrics in
``bench/metrics/<metric>.py`` (each a ``read(ctx)`` that returns a number,
or None where it finds nothing to read) and its limits in
``bench/limits/<cell>.json``.

The window drives ``DecentralizedTrainer.run_fused``, on a trainer built as
the runner builds one for a spec: each call is one spec's run of the
traffic's ``rounds_per_call`` rounds at its ``eval_every``, with its staging
and CUDA-graph capture; the state carries from call to call and each call
draws fresh batches (``NodeLoader``'s ``index_fn``). Set-up ends with one
such call, call 0, whose rounds up to the traffic's ``check_round`` the
reference replays afterwards: the state at that round, and the evaluation
records up to its ``records_round``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from bench import check, counts, trace
from bench.inputs import Inputs, make_inputs
from bench.reference import decavg as reference

__all__ = ["ROOT", "FORBIDDEN", "Cell", "Context", "load_cell", "run"]

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict[str, Any]
    traffic: dict[str, Any]
    per_layer: dict[str, str]  # the cell's per-layer metrics and their units
    end_to_end: dict[str, str]  # the cell's end-to-end metrics and their units


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, *, root: Path = ROOT, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``root``'s manifest, with its configuration and
    traffic (``overrides`` merged into the traffic, for tests at a small
    size)."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    (conf,) = [c for c in manifest["configs"] if c["name"] == w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    per_layer, end_to_end = ({m["name"]: m["unit"] for m in manifest[section]
                              if "workloads" not in m or name in m["workloads"]}
                             for section in ("per_layer", "end_to_end"))
    return Cell(name, int(w["chips"]), config, _merge(traffic, overrides or {}), per_layer,
                end_to_end)


class _Feed:
    """``NodeLoader``'s ``index_fn``: the positions of the current call's
    round, drawn from the run's seed."""

    def __init__(self, inputs: Inputs):
        self.inputs = inputs
        self.call = 0

    def __call__(self, round_: int, steps: int) -> np.ndarray:
        if steps != self.inputs.steps:
            raise RuntimeError(f"the program takes {steps} local steps a round, the "
                               f"algorithm {self.inputs.steps}")
        return self.inputs.positions(self.call, round_)


def build_trainer(cell: Cell, inputs: Inputs, feed: _Feed, devices: list[torch.device]):
    """``DecentralizedTrainer`` as ``experiments.runner`` builds it for the
    cell's spec, handed the benchmark's graph, data, split, first member and
    batch draws."""
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core.topology import Graph
    from repro_torch.data.loader import NodeLoader
    from repro_torch.train.trainer import DecentralizedTrainer

    cfg, tr = cell.config, cell.traffic
    home = devices[0]
    n = inputs.graph.n
    loader = NodeLoader(inputs.ds.x_train, inputs.ds.y_train, inputs.parts,
                        batch_size=inputs.batch, device=home, index_fn=feed)
    graph = Graph(adj=inputs.graph.adj, blocks=inputs.graph.blocks, name=tr["topology"]["family"])
    params = {"layers": [{k: v.expand(n, *v.shape) for k, v in lay.items()}
                         for lay in inputs.member]}
    backend = tr["backend"]
    mesh = mesh_mod.Mesh(devices, ("data",)) if backend == "sparse_sharded" else None
    trainer = DecentralizedTrainer(
        graph, loader, lr=cfg["lr"], momentum=cfg["momentum"], mix_impl=backend,
        matrix="decavg", sparse_p_chunk=tr.get("sparse_p_chunk"), seed=0,
        in_dim=cfg["in_dim"], hidden=tuple(cfg["hidden"]), num_classes=cfg["num_classes"],
        class_groups=inputs.groups, params=params, mesh=mesh, device=home,
    )
    if not trainer.supports_fused:
        raise RuntimeError(f"backend {trainer.mix_impl!r} has no run_fused")
    return trainer


@dataclasses.dataclass
class Context:
    """What a per-layer reader may read."""

    cell: Cell
    inputs: Inputs
    trainer: Any
    devices: list[torch.device]
    window: dict[str, float]  # seconds, rounds, calls, evals, gossip_rounds, median_call_s
    trace: trace.Summary | None
    wire: dict[str, int]  # bytes between shards over the window, by kind
    peaks: dict | None
    _memo: dict = dataclasses.field(default_factory=dict)

    def value(self, metric: str) -> float | None:
        """Another per-layer metric's reading, read once."""
        if metric not in self._memo:
            self._memo[metric] = _reader(metric)(self)
        return self._memo[metric]

    def sync(self) -> None:
        sync(self.devices)

    @property
    def param_count(self) -> int:
        return counts.param_count(self.inputs.dims)


def _reader(metric: str) -> Callable[[Context], float | None]:
    path = ROOT / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Laps:
    """Seconds between successive points of a run, for standard error."""

    def __init__(self, t0: float):
        self.t = t0
        self.times: list[tuple[str, float]] = []

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.times.append((name, now - self.t))
        self.t = now


def sync(devices: list[torch.device]) -> None:
    """Wait for every card among ``devices``."""
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _loaded_forbidden() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _peak_bytes(devices: list[torch.device]) -> int:
    return max((torch.cuda.max_memory_allocated(d) for d in dict.fromkeys(devices)
                if d.type == "cuda"), default=0)


def first_call(cell: Cell, inputs: Inputs, devices: list[torch.device]):
    """Build the trainer and run call 0, whose rounds up to ``check_round``
    the reference replays; returns the trainer, its feed, the call (a function of
    ``on_round``) and the readings of the program's side."""
    tr = cell.traffic
    rounds, every = int(tr["rounds_per_call"]), int(tr["eval_every"])
    feed = _Feed(inputs)
    trainer = build_trainer(cell, inputs, feed, devices)
    x_test, y_test = inputs.ds.x_test, inputs.ds.y_test

    def call(on_round) -> None:
        trainer.run_fused(rounds, eval_every=every, x_test=x_test, y_test=y_test,
                          on_round=on_round)
        sync(devices)

    at, upto = check_round(cell), records_round(cell)
    records: list = []
    state: list[check.Side] = []

    def on_round(m) -> None:
        records.append(m)
        if m.round == at and not sharded:
            state.append(read_state())

    def read_state() -> check.Side:
        return check.program_side(trainer.params["layers"], trainer.momentum["layers"],
                                  inputs.member, [m for m in records if m.round <= upto],
                                  inputs.spread)

    # A sharded run's state shows only once its call has gathered it.
    sharded = trainer.mix_impl == "sparse_sharded"
    if sharded and at != rounds - 1:
        raise SystemExit(f"{cell.name}: a sharded run's state is read at its last round, "
                         f"not round {at}")
    call(on_round)
    prog = read_state() if sharded else state[0]
    sync(devices)
    return trainer, feed, call, prog


def check_round(cell: Cell) -> int:
    """The round of call 0 whose state the reference compares (the
    traffic's ``check_round``): an evaluated round."""
    tr = cell.traffic
    rounds, every = int(tr["rounds_per_call"]), int(tr["eval_every"])
    at = int(tr["check_round"])
    if at not in evaluated_rounds(rounds, every):
        raise SystemExit(f"{cell.name}: check_round {at} is not an evaluated round")
    return at


def records_round(cell: Cell) -> int:
    """The last round of call 0 whose evaluation records are compared, with
    every earlier evaluated round's (the traffic's ``records_round``; by
    default ``check_round``): an evaluated round, not after ``check_round``."""
    tr = cell.traffic
    at = check_round(cell)
    upto = int(tr.get("records_round", at))
    if upto > at or upto not in evaluated_rounds(int(tr["rounds_per_call"]),
                                                 int(tr["eval_every"])):
        raise SystemExit(f"{cell.name}: records_round {upto} is not an evaluated round "
                         f"up to check_round {at}")
    return upto


def evaluated_rounds(rounds: int, every: int) -> list[int]:
    """The rounds of a call that ``run_fused`` evaluates: every
    ``every``-th and the last."""
    return [r for r in range(rounds) if r % every == 0 or r == rounds - 1]


def reference_side(cell: Cell, inputs: Inputs, device: torch.device,
                   precision: str = "f32") -> check.Side:
    """The reference's replay of call 0 up to its ``check_round`` and its
    readings, with the records up to ``records_round``."""
    tr = cell.traffic
    rep = reference.replay(inputs, rounds=check_round(cell) + 1,
                           eval_every=int(tr["eval_every"]), lr=cell.config["lr"],
                           momentum=cell.config["momentum"], device=device, precision=precision)
    upto = records_round(cell)
    rep.evals[:] = [e for e in rep.evals if e["round"] <= upto]
    return check.reference_side(rep, inputs.member, inputs.spread)


def run(name: str, *, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", overrides: dict | None = None) -> dict[str, Any]:
    """One run of cell ``name``; returns the result line's object. With
    ``device="cpu"`` (tests) the cell's shards all sit on the CPU."""
    cell = load_cell(name, overrides=overrides)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{cell.name} needs {cell.chips} CUDA card(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                             f"available")
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
        for d in devices:
            torch.cuda.synchronize(d)  # the card's context, before its counters
            torch.cuda.reset_peak_memory_stats(d)
    else:
        devices = [torch.device("cpu")] * cell.chips
    import repro_torch.device  # noqa: F401  (TF32 off, as the program states)
    from repro_torch.core import mesh as mesh_mod

    tr = cell.traffic
    rounds = int(tr["rounds_per_call"])
    laps = _Laps(t_start)
    laps.lap("imports and CUDA")
    inputs = make_inputs(cell.config, tr, seed, devices[0])
    laps.lap("inputs")
    trainer, feed, call, prog = first_call(cell, inputs, devices)
    laps.lap("trainer and call 0")
    evals_per_call = len(evaluated_rounds(rounds, int(tr["eval_every"])))
    setup_s = time.perf_counter() - t_start

    gossip_per_call = rounds  # gossip_every is 1: every round mixes
    mesh_mod.reset_wire_bytes()
    n_calls = 0
    ends: list[float] = []
    t0 = time.perf_counter()
    while True:
        feed.call += 1
        call(None)
        n_calls += 1
        ends.append(time.perf_counter())
        if n_calls == 1:
            # What one spec's run needs: set-up and one call of the window,
            # whatever number of calls the window holds.
            run_peak = _peak_bytes(devices)
        if ends[-1] - t0 >= seconds:
            break
    window_s = ends[-1] - t0
    per_call = np.diff([t0, *ends])
    laps.lap(f"window ({n_calls} calls)")
    wire = mesh_mod.wire_bytes()
    peak = _peak_bytes(devices)
    events: list = []
    if traced:  # one more call, traced, once the window has closed
        feed.call += 1
        with trace.traced(events):
            call(None)
        laps.lap("traced call")

    window = {"seconds": window_s, "rounds": n_calls * rounds, "calls": n_calls,
              "evals": n_calls * evals_per_call, "gossip_rounds": n_calls * gossip_per_call,
              "median_call_s": float(np.median(per_call))}
    kind = torch.cuda.get_device_name(devices[0]) if devices[0].type == "cuda" else "cpu"
    dev_info: dict[str, Any] = {"platform": "gpu" if devices[0].type == "cuda" else "cpu",
                                "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if traced:
        summ = trace.summarize(events[0])
        ctx = Context(cell, inputs, trainer, devices, window, summ, wire, counts.peaks_for(kind))
        metrics = {}
        for m, unit in cell.per_layer.items():
            v = ctx.value(m)
            if v is not None:
                metrics[m] = {"value": float(v), "unit": unit}
        dev_info["busy_s"] = summ.mean_busy_s(cell.chips)
        dev_info["window_s"] = summ.window_s
        breakdown = {"device_ops": summ.device_ops, "idle_gaps": summ.idle_gaps}
        del ctx
    else:
        taken = {"rounds_per_s": window["rounds"] / window_s,
                 "peak_mem_gib": run_peak / 2**30, "setup_s": setup_s}
        metrics = {m: {"value": taken[m], "unit": unit} for m, unit in cell.end_to_end.items()}

    # The program's state goes before the reference runs on the same cards.
    del trainer
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    laps.lap("per-layer readings" if traced else "after the window")
    numbers = check.gaps(prog, reference_side(cell, inputs, devices[0]))
    laps.lap("reference")
    print("phases " + ", ".join(f"{k} {v:.3f} s" for k, v in laps.times), file=sys.stderr)
    print(f"calls {len(per_call)}: min {per_call.min():.4f} s, median {np.median(per_call):.4f} s, "
          f"max {per_call.max():.4f} s; first {per_call[0]:.4f} s", file=sys.stderr)
    print("call seconds " + " ".join(f"{t:.4f}" for t in per_call), file=sys.stderr)
    print(f"peak {run_peak} B after the window's first call, {peak} B at its end", file=sys.stderr)
    if traced:
        print(f"traced call {summ.window_s:.4f} s, busy {summ.mean_busy_s(cell.chips):.4f} s "
              f"(mean over the cards)", file=sys.stderr)
    correct, checked = check.judge(numbers, check.load_limits(ROOT, cell.name))
    for k in check.NUMBERS:
        if k not in checked:
            print(f"check {k} {numbers[k]:.6e} not compared (no limit)", file=sys.stderr)
    for k, v in checked.items():
        print(f"check {k} {v['value']:.6e} limit {v['limit']:.6e}", file=sys.stderr)
    bad = _loaded_forbidden()
    if bad:
        raise SystemExit(f"modules of the JAX package or JAX loaded: {', '.join(bad)}")
    out: dict[str, Any] = {"correct": correct, "attempted": window["rounds"], "failed": 0,
                           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["numbers"] = numbers
    out["checked"] = checked
    return out

