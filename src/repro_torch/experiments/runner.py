"""Executes ExperimentSpecs and streams per-round records to a ResultsStore.

The port's counterpart of ``repro.experiments.runner`` for the paper's
``mlp`` executor: synthetic MNIST-like data, graph-aware partitioners and
``DecentralizedTrainer``. It streams the reference's records per round
(per-node accuracy stats, G1/G2 class-group accuracy on all, focus and
spread nodes, consensus distance, wall-clock) and the same ``run_end``
summary, plus ``framework`` and ``device``. As in the reference, a run takes
the trainer's ``run_fused`` when its backend supports it (dense, sparse,
sparse_pallas, sparse_sharded) unless the spec says ``model={"fused": False}``, and
``final.fused`` records the path it took. A spec with ``faults`` also records
``alive_count`` per evaluated round, and ``faults``, ``alive_min``,
``alive_final``, ``churn_rounds`` and ``recovery_rounds`` in its summary;
``model={"compress": k}`` turns on CHOCO gossip.

The ``lm`` executor (``model={"kind": "lm", ...}``) trains an LLM cohort
through ``LMCohortTrainer`` on the reference's token streams: reduced
members with f32 params unless ``model={"full_scale": True}``, which keeps
the arch's own widths and bf16. It streams loss, lr, ``domain_acc`` and
``g2_token_spread`` per evaluated round and ends with the reference's
summary keys (consensus, graph records, ``members_m``, ``backend``,
``fused``, ``compress``, and under faults ``faults``, ``alive_min`` and
``alive_final``), plus ``framework`` and ``device``.

``run_sweep`` skips specs whose run_id already has a completed ``run_end``
in the store. ``run_id`` is the reference's content hash, so keep the two
packages' stores apart (the sweep CLI's default store names do). With
``processes > 1`` the specs fan out over a spawn-context process pool; each
worker writes a private shard that is merged into the store.
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import device_name, resolve_device
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.store import ResultsStore

__all__ = ["run_spec", "run_sweep", "build_partition", "default_class_groups"]

Emit = Callable[[dict[str, Any]], None]


def default_class_groups(num_classes: int) -> np.ndarray:
    """Paper split: lower half of the classes is G1 (everyone), upper half G2."""
    g = np.zeros(num_classes, dtype=np.int32)
    g[num_classes // 2 :] = 1
    return g


def build_partition(spec: ExperimentSpec, g, labels: np.ndarray) -> list[np.ndarray]:
    """Dispatch spec.partitioner over core/partition.py with the realized graph."""
    from repro_torch.core import partition as P

    kw = dict(spec.partitioner_params)
    n = g.num_nodes
    if spec.partitioner == "iid":
        return P.iid(labels, n, seed=spec.seed, **kw)
    if spec.partitioner == "hub_focused":
        return P.hub_focused(labels, g, seed=spec.seed, **kw)
    if spec.partitioner == "edge_focused":
        return P.edge_focused(labels, g, seed=spec.seed, **kw)
    if spec.partitioner == "community":
        return P.community(labels, g, seed=spec.seed, **kw)
    if spec.partitioner == "dirichlet":
        kw.setdefault("beta", 0.5)
        return P.dirichlet(labels, n, seed=spec.seed, **kw)
    raise ValueError(f"unknown partitioner {spec.partitioner!r}")


def _graph_record(g, w: np.ndarray) -> dict[str, Any]:
    """graph_summary + spectral gap of the realized W (exact up to N=1024)."""
    from repro_torch.core import mixing, topology

    rec = topology.graph_summary(g)
    rec["spectral_gap"] = mixing.spectral_gap(w) if g.num_nodes <= 1024 else None
    return rec


_MAX_GRAPH_PERIODS = 32


def _graph_records(engine, rounds: int) -> dict[str, Any]:
    """Graph summaries for every schedule period the run realized: ``graph``
    (period 0), plus ``graph_periods`` and ``graph_mean`` for multi-period
    runs, sampled evenly past ``_MAX_GRAPH_PERIODS`` periods (the reference's
    rule and record layout)."""
    first_round: dict[int, int] = {}
    for r in range(max(int(rounds), 1)):
        first_round.setdefault(engine.schedule.period_of(r), r)
    periods = sorted(first_round)
    num_periods = len(periods)
    sampled = num_periods > _MAX_GRAPH_PERIODS
    if sampled:
        pick = np.linspace(0, num_periods - 1, _MAX_GRAPH_PERIODS).round()
        periods = [periods[int(i)] for i in np.unique(pick)]
    recs = []
    for p in periods:
        g = engine.graph_at(first_round[p])
        rec = _graph_record(g, engine.w.cpu().numpy())
        rec["period"] = p
        recs.append(rec)
    out: dict[str, Any] = {"graph": recs[0], "graph_num_periods": num_periods}
    if len(recs) > 1:
        out["graph_periods"] = recs
        if sampled:
            out["graph_periods_sampled"] = True
        out["graph_mean"] = {
            k: float(np.mean([r[k] for r in recs]))
            for k, v in recs[0].items()
            if k != "period"
            and isinstance(v, (int, float)) and not isinstance(v, bool)
            and all(isinstance(r.get(k), (int, float)) for r in recs)
        }
    return out


def _run_mlp(spec: ExperimentSpec, emit: Emit, verbose: bool,
             device: torch.device) -> dict[str, Any]:
    from repro_torch.core import topology
    from repro_torch.core.partition import partition_summary
    from repro_torch.data.loader import NodeLoader
    from repro_torch.data.synthetic import make_mnist_like
    from repro_torch.train.trainer import DecentralizedTrainer

    ds = make_mnist_like(**spec.data)
    schedule = topology.make_schedule(spec.topology, seed=spec.seed)
    parts = build_partition(spec, schedule.graph_at(0), ds.y_train)

    num_classes = ds.num_classes
    groups = default_class_groups(num_classes)
    summ = partition_summary(ds.y_train, parts)
    holds_g2 = summ[:, np.flatnonzero(groups == 1)].sum(axis=1) > 0
    focus_nodes = np.flatnonzero(holds_g2)
    spread_nodes = np.flatnonzero(~holds_g2)

    loader = NodeLoader(
        ds.x_train, ds.y_train, parts, batch_size=spec.batch_size,
        seed=spec.seed + 1, device=device,
    )
    hidden = spec.model.get("hidden")
    trainer = DecentralizedTrainer(
        schedule,
        loader,
        lr=spec.lr,
        momentum=spec.momentum,
        local_epochs=spec.local_epochs,
        mix_impl=spec.backend,
        matrix=spec.matrix,
        sparse_p_chunk=spec.model.get("sparse_p_chunk"),
        gossip_every=spec.gossip_every,
        compress=spec.model.get("compress"),
        faults=spec.faults,
        same_init=spec.same_init,
        seed=spec.seed,
        in_dim=int(spec.model.get("in_dim", ds.x_train.shape[1])),
        hidden=None if hidden is None else tuple(hidden),
        num_classes=num_classes,
        class_groups=groups,
        device=device,
    )
    fault_trace = None
    if trainer.faulted:
        fault_trace = trainer.engine.fault_trace
        fault_trace.ensure(spec.rounds)
    last: dict[str, Any] = {}
    curve: list[tuple[int, float | None]] = []  # (round, g2_acc_spread) evals

    def on_round(m) -> None:
        rec: dict[str, Any] = {
            "round": m.round,
            "mean_acc": m.mean_acc,
            "std_acc": m.std_acc,
            "min_acc": float(m.per_node_acc.min()),
            "max_acc": float(m.per_node_acc.max()),
            "g1_acc": float(m.group_acc[:, 0].mean()),
            "g2_acc": float(m.group_acc[:, 1].mean()),
            "g2_acc_focus": (
                float(m.group_acc[focus_nodes, 1].mean()) if len(focus_nodes) else None
            ),
            "g2_acc_spread": (
                float(m.group_acc[spread_nodes, 1].mean()) if len(spread_nodes) else None
            ),
            "consensus_mean": float(m.consensus.mean()),
            "consensus_max": float(m.consensus.max()),
            "wall_s": round(m.wall_s, 4),
        }
        if fault_trace is not None:
            rec["alive_count"] = int(fault_trace.alive(m.round).sum())
        curve.append((m.round, rec["g2_acc_spread"]))
        last.clear()
        last.update(rec)
        emit(rec)
        if verbose:
            print(
                f"    round {m.round:4d}  acc {m.mean_acc:.4f}  "
                f"g2_spread {rec['g2_acc_spread']}  cons {rec['consensus_mean']:.3g}"
            )

    use_fused = bool(spec.model.get("fused", True)) and trainer.supports_fused
    run = trainer.run_fused if use_fused else trainer.run
    run(
        spec.rounds, eval_every=spec.eval_every,
        x_test=ds.x_test, y_test=ds.y_test, on_round=on_round,
    )

    final: dict[str, Any] = {
        **last,
        **_graph_records(trainer.engine, spec.rounds),
        "num_focus_nodes": int(len(focus_nodes)),
        "num_spread_nodes": int(len(spread_nodes)),
        "backend": trainer.mix_impl,
        "fused": use_fused,
        "framework": "torch",
        "device": device_name(device),
    }
    if fault_trace is not None:
        from repro_torch.core import faults as faults_mod

        alive_counts = [int(fault_trace.alive(r).sum()) for r in range(spec.rounds)]
        events = faults_mod.churn_rounds(alive_counts, trainer.num_nodes)
        final["faults"] = spec.faults
        final["alive_min"] = min(alive_counts)
        final["alive_final"] = alive_counts[-1]
        final["churn_rounds"] = events
        final["recovery_rounds"] = (
            faults_mod.recovery_rounds([r for r, _ in curve], [a for _, a in curve], events[0])
            if events else None
        )
    # Community runs additionally record the paper's Table-1 confusion view.
    if trainer.graph.blocks is not None and trainer.graph.num_nodes <= 256:
        from repro_torch.train.metrics import community_confusion

        cms = torch.as_tensor(trainer.confusion(ds.x_test, ds.y_test))
        blocks = trainer.graph.blocks
        num_comms = int(blocks.max()) + 1
        comm_cm = community_confusion(cms, torch.as_tensor(blocks), num_comms).numpy()
        off_diag = comm_cm.copy()
        for b in range(num_comms):
            np.fill_diagonal(off_diag[b], 0.0)
        final["community_confusion_offdiag"] = [
            float(off_diag[b].sum()) for b in range(num_comms)
        ]
        if comm_cm.size <= 1000:
            final["community_confusion"] = comm_cm.round(4).tolist()
    return final


def _allocated_by_card(device: torch.device) -> list[int]:
    """Bytes allocated on each local card (none off the card)."""
    if device.type != "cuda":
        return []
    return [torch.cuda.memory_allocated(c) for c in range(torch.cuda.device_count())]


def _run_lm(spec: ExperimentSpec, emit: Emit, verbose: bool,
            device: torch.device) -> dict[str, Any]:
    from repro_torch.configs import base as cfgbase
    from repro_torch.train.trainer import LMCohortTrainer

    m = spec.model
    cfg = cfgbase.get(m.get("arch", "llama3.2-1b"))
    if not m.get("full_scale", False):
        cfg = dataclasses.replace(cfg.reduced(), param_dtype="float32", optimizer=cfg.optimizer)
    n = int(m.get("nodes", 4))
    held = _allocated_by_card(device)
    trainer = LMCohortTrainer(
        spec.topology,
        cfg,
        nodes=n,
        batch=int(m.get("batch", 4)),
        seq=int(m.get("seq", 128)),
        lr=spec.lr,
        schedule=m.get("schedule", "cosine"),
        backend=spec.backend,
        matrix=spec.matrix,
        gossip_every=spec.gossip_every,
        compress=m.get("compress", "auto"),
        faults=spec.faults,
        seed=spec.seed,
        device=device,
    )
    if verbose:
        print(
            f"arch={cfg.arch_id} members={trainer.member_params / 1e6:.1f}M x {n} nodes "
            f"topology={trainer.graph.name} backend={trainer.mix_impl} "
            f"optimizer={cfg.optimizer} schedule={m.get('schedule', 'cosine')} "
            f"compress={trainer.compress} device={device_name(device)}"
        )
        if trainer.sharded:
            rise = [b - a for a, b in zip(held, _allocated_by_card(device))]
            print(f"state sharded over {trainer.shards} shards on "
                  f"{', '.join(str(d) for d in trainer.engine.shard_devices)}, "
                  f"{n // trainer.shards} members a shard; state bytes by shard "
                  f"{trainer.shard_state_bytes()}"
                  + (f"; allocated after construction by card {rise}" if rise else ""))
    ckpt_every, ckpt_path = int(m.get("ckpt_every", 0)), m.get("ckpt_path", "")
    if m.get("resume") and ckpt_path:
        start = trainer.restore(ckpt_path)
        if verbose:
            print(f"resumed from {ckpt_path} at round {start}")

    last: dict[str, Any] = {}

    def on_round(rec: dict[str, Any]) -> None:
        last.clear()
        last.update(rec)
        emit(rec)

    # Fused by default, as for mlp; model={"fused": False} opts out, and
    # backends run_fused does not stage (pallas) take the loop.
    use_fused = bool(m.get("fused", True)) and trainer.supports_fused
    run = trainer.run_fused if use_fused else trainer.run
    run(spec.rounds, eval_every=spec.eval_every, on_round=on_round,
        ckpt_every=ckpt_every, ckpt_path=ckpt_path, verbose=verbose)
    cons = trainer.consensus()
    final: dict[str, Any] = {
        **last,
        "consensus_mean": float(cons.mean()) if cons.size else 0.0,
        "consensus_max": float(cons.max()) if cons.size else 0.0,
        **_graph_records(trainer.engine, spec.rounds),
        "members_m": round(trainer.member_params / 1e6, 2),
        "backend": trainer.mix_impl,
        "fused": use_fused,
        "compress": trainer.compress,
        "framework": "torch",
        "device": device_name(device),
    }
    if trainer.faulted:
        trace = trainer.engine.fault_trace
        alive_counts = [int(trace.alive(r).sum()) for r in range(spec.rounds)]
        final["faults"] = spec.faults
        final["alive_min"] = min(alive_counts)
        final["alive_final"] = alive_counts[-1]
    return final


_EXECUTORS = {"mlp": _run_mlp, "lm": _run_lm}


def _executor(spec: ExperimentSpec):
    kind = spec.model.get("kind", "mlp")
    if kind not in _EXECUTORS:
        raise ValueError(f"unknown model kind {kind!r}; one of {sorted(_EXECUTORS)}")
    return _EXECUTORS[kind]


def run_spec(
    spec: ExperimentSpec,
    store: ResultsStore,
    *,
    verbose: bool = False,
    raise_on_error: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Execute one spec on ``device`` (None means CUDA), streaming records to
    ``store``. Returns the final summary (also written as the ``run_end``
    record)."""
    device = resolve_device(device)
    rid = spec.run_id
    store.run_start(rid, spec.to_json())
    t0 = time.perf_counter()
    try:
        final = _executor(spec)(spec, lambda rec: store.round(rid, rec), verbose, device)
    except Exception as e:  # noqa: BLE001 — sweep must survive one bad spec
        store.run_end(rid, "failed", error=f"{type(e).__name__}: {e}")
        if raise_on_error:
            raise
        if verbose:
            traceback.print_exc()
        return {"status": "failed", "run_id": rid, "error": str(e)}
    store.run_end(rid, "completed", wall_s=round(time.perf_counter() - t0, 4),
                  final=final)
    return {"status": "completed", "run_id": rid, "final": final}


def _worker(args: tuple[dict[str, Any], str, bool, str]) -> str:
    """Process-pool entry: run one spec on ``device`` into a private JSONL
    shard. The device comes as a string: the worker makes its own CUDA
    context."""
    spec_json, shard_path, verbose, device = args
    spec = ExperimentSpec.from_json(spec_json)
    run_spec(spec, ResultsStore(shard_path), verbose=verbose, raise_on_error=False,
             device=device)
    return shard_path


def _merge_shard(store: ResultsStore, shard: str) -> None:
    with open(shard) as f:
        store.append_lines(f)
    os.remove(shard)


def _salvage_shards(
    store: ResultsStore, shard_dir: str, verbose: bool, *, min_age_s: float = 0.0
) -> int:
    """Merge and remove the shard files a dead worker (or killed parent) left
    in ``shard_dir``, then drop the directory.

    Salvaged partial shards lack their ``run_end`` line, so resume re-runs
    them. Called before a sweep, with ``min_age_s`` so that a concurrent
    sweep's in-flight shards are left alone."""
    if not os.path.isdir(shard_dir):
        return 0
    import glob

    salvaged = 0
    for shard in sorted(glob.glob(os.path.join(shard_dir, "*.jsonl"))):
        try:
            if min_age_s and time.time() - os.path.getmtime(shard) < min_age_s:  # lint: allow[D002] — shard age vs file mtime needs the wall clock
                continue  # likely still being written by a live sweep
            _merge_shard(store, shard)
            salvaged += 1
        except FileNotFoundError:
            continue  # another sweep salvaged it between glob and merge
    try:
        os.rmdir(shard_dir)
    except OSError:
        pass  # a concurrent sweep may still be writing here; leave it
    if verbose and salvaged:
        print(f"salvaged {salvaged} stale shard(s) from {shard_dir}")
    return salvaged


def _run_pool(todo: list[ExperimentSpec], store: ResultsStore, shard_dir: str,
              processes: int, verbose: bool, device: torch.device) -> None:
    """Run ``todo`` over a spawn-context process pool, one shard a spec."""
    import concurrent.futures as cf
    import multiprocessing as mp

    os.makedirs(shard_dir, exist_ok=True)
    jobs = [(s.to_json(), os.path.join(shard_dir, f"{s.run_id}.jsonl"), verbose, str(device))
            for s in todo]
    # Spawn, never fork: the parent may hold a CUDA context. And a process
    # pool executor, not mp.Pool: a worker killed mid-run fails its future
    # (BrokenProcessPool) instead of blocking on the lost result forever.
    try:
        with cf.ProcessPoolExecutor(max_workers=min(processes, len(jobs)),
                                    mp_context=mp.get_context("spawn")) as pool:
            for fut in cf.as_completed([pool.submit(_worker, j) for j in jobs]):
                try:
                    _merge_shard(store, fut.result())
                except Exception as e:  # noqa: BLE001 — keep draining; the run shows as failed
                    if verbose:
                        print(f"worker failed: {type(e).__name__}: {e}")
    finally:
        # Whatever this sweep's own workers left behind (a killed worker's
        # partial shard); a concurrent sweep's shards are not ours to take.
        for _, shard, _, _ in jobs:
            try:
                _merge_shard(store, shard)
            except FileNotFoundError:
                pass  # merged in the loop above
        try:
            os.rmdir(shard_dir)
        except OSError:
            pass  # non-empty: a concurrent sweep is still writing here


def run_sweep(
    specs: list[ExperimentSpec],
    store_path: str,
    *,
    resume: bool = True,
    processes: int = 1,
    verbose: bool = False,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Run a list of specs against one results store.

    With ``resume`` (default), specs whose run_id already has a completed
    run_end are skipped. With ``processes > 1``, specs fan out over a
    spawn-context process pool; each worker writes a private shard, merged
    into the store as it completes. On one card the workers share it.
    """
    device = resolve_device(device)
    store = ResultsStore(store_path)
    shard_dir = store_path + ".shards"
    _salvage_shards(store, shard_dir, verbose, min_age_s=60.0)
    done = store.completed() if resume else set()
    todo = [s for s in specs if s.run_id not in done]
    skipped = len(specs) - len(todo)
    if verbose and skipped:
        print(f"resume: skipping {skipped} completed run(s)")
    if processes <= 1 or len(todo) <= 1:
        statuses = []
        for i, spec in enumerate(todo):
            if verbose:
                print(f"[{i + 1}/{len(todo)}] {spec.run_id}  ({spec.topology} "
                      f"x {spec.partitioner})")
            statuses.append(
                run_spec(spec, store, verbose=verbose, raise_on_error=False, device=device)
            )
        failed = [s["run_id"] for s in statuses if s["status"] != "completed"]
    else:
        _run_pool(todo, store, shard_dir, processes, verbose, device)
        finals = store.finals()
        failed = [s.run_id for s in todo if s.run_id not in finals]
    return {
        "total": len(specs),
        "ran": len(todo),
        "skipped": skipped,
        "failed": failed,
        "store": store.path,
    }
