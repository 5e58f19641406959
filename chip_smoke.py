#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and no phase catches and
carries on:

1. device   -- the card's name, and its name and power limit from nvidia-smi;
2. build    -- compile the gossip_mix kernel from the repo's CUDA source;
3. kernel   -- the kernel against its plain PyTorch version on the card, at
               the main path's 8 leaf shapes, a ragged shape, (1, 1) and an
               N=300 ring (whole zero W tiles), in f32 (3e-5) and bf16 (2e-2),
               with tile skipping on and off;
4. times    -- CUDA-event times of one gossip round's 8 launches: kernel,
               plain version, torch.matmul, and the least time the card
               could take for the same work;
5. main     -- the paper's DecAvg run through run_spec at full width (BA
               N=100, the 784-512-256-128-10 MLP, backend "pallas"): records
               stream, accuracy is finite and above chance, the kernel ran
               8 times per gossip round, and the run agrees with the dense
               backend;
6. checks   -- the port's smoke preset and its qualitative checks (printed,
               not asserted: the port's RNG differs from JAX's).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA card, or without
the repo beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
MLP_DIMS = (784, 512, 256, 128, 10)
# (N, D) of each flattened leaf of the paper MLP, in the trainer's leaf order.
LEAF_D = tuple(d for a, b in zip(MLP_DIMS[:-1], MLP_DIMS[1:]) for d in (b, a * b))
MAIN_SPEC = dict(
    topology="ba:n=100,m=2", partitioner="hub_focused", rounds=6, eval_every=2,
    batch_size=32, lr=0.05, momentum=0.9,
)
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main_path_w(dev):
    """The main path's mixing matrix: decavg weights over the BA graph with
    the hub_focused partition's data sizes, exactly as the runner builds it."""
    from repro_torch.core import topology
    from repro_torch.core.decavg import GossipEngine
    from repro_torch.data.synthetic import make_mnist_like
    from repro_torch.experiments.runner import build_partition
    from repro_torch.experiments.spec import ExperimentSpec

    spec = ExperimentSpec(**MAIN_SPEC)
    ds = make_mnist_like(**spec.data)
    parts = build_partition(spec, topology.make_schedule(spec.topology, seed=spec.seed).graph_at(0),
                            ds.y_train)
    sizes = np.array([len(p) for p in parts], dtype=np.float64)
    return GossipEngine(spec.topology, data_sizes=sizes, backend="dense", seed=spec.seed,
                        device=dev).w


def ring_w(n: int, dev) -> torch.Tensor:
    w = torch.zeros(n, n)
    for i in range(n):
        for j in (i - 1, i, i + 1):
            w[i, j % n] = 1.0 / 3.0
    return w.to(dev)


def block_sparse_w(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    w = torch.rand(n, n, generator=gen, device=dev)
    w[: n // 2, n // 2:] = 0.0
    w += torch.eye(n, device=dev)
    return w / w.sum(dim=1, keepdim=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.experiments import analysis, presets, runner
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.experiments.store import ResultsStore
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.train.trainer import DecentralizedTrainer

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase("device", f"torch: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = gm.build()
    gm._library()
    phase("build", f"{lib.name} built and loaded in {time.perf_counter() - t0:.2f} s")

    # 3. kernel against plain, on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    w_main = main_path_w(dev)
    cases = [(f"leaf(100,{d})", w_main, d) for d in LEAF_D]
    cases += [("ragged(130,513)", block_sparse_w(130, gen, dev), 513),
              ("(1,1)", torch.ones(1, 1, device=dev), 1),
              ("ring(300,65536)", ring_w(300, dev), 65536)]
    main_err = 0.0
    for name, w, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            p = (torch.rand(w.shape[1], d, generator=gen, device=dev) * 2 - 1).to(dtype)
            want = gm.gossip_mix_ref(w, p).float()
            for skip in (True, False):
                got = gm.gossip_mix(w, p, block_sparse=skip)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != want.shape:
                    fail(f"{name} {dtype}: got {got.dtype} {tuple(got.shape)}")
                err = float((got.float() - want).abs().max())
                phase("kernel", f"{name:18s} {str(dtype):15s} skip={int(skip)} "
                                f"max_abs_err={err:.3e} (tol {TOL[dtype]:g})")
                if not err <= TOL[dtype]:
                    fail(f"{name} {dtype} skip={skip}: max_abs_err {err} > {TOL[dtype]}")
                if name.startswith("leaf") and dtype == torch.float32:
                    main_err = max(main_err, err)

    # 4. times of one gossip round at the main path's shapes (f32)
    leaves = [torch.rand(100, d, generator=gen, device=dev) * 2 - 1 for d in LEAF_D]
    t_kernel = time_ms(lambda: [gm.gossip_mix(w_main, p) for p in leaves])
    t_plain = time_ms(lambda: [gm.gossip_mix_ref(w_main, p) for p in leaves])
    t_lib = time_ms(lambda: [torch.matmul(w_main, p) for p in leaves])
    nnz = int((w_main != 0).sum())
    n = w_main.shape[0]
    d_total = sum(LEAF_D)
    bytes_moved = 4 * (2 * n * d_total + len(LEAF_D) * n * n)
    ops = 2 * nnz * d_total  # the multiply-adds this W needs; dense would be 2*n*n*D
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    dense_ops_ms = 2 * n * n * d_total / F32_FLOP_PER_S * 1e3
    for d, p in zip(LEAF_D, leaves):
        tk = time_ms(lambda p=p: gm.gossip_mix(w_main, p))
        tl = time_ms(lambda p=p: torch.matmul(w_main, p))
        leaf_bound = 4 * 2 * n * d / HBM_BYTES_PER_S * 1e3
        phase("times", f"leaf(100,{d}): kernel {tk:.4f} ms, torch.matmul {tl:.4f} ms, "
                       f"bytes bound {leaf_bound:.4f} ms")
    w_ring = ring_w(300, dev)
    p_ring = torch.rand(300, 401408, generator=gen, device=dev)
    t_skip = time_ms(lambda: gm.gossip_mix(w_ring, p_ring, block_sparse=True))
    t_noskip = time_ms(lambda: gm.gossip_mix(w_ring, p_ring, block_sparse=False))
    phase("times", f"ring(300,401408): skip on {t_skip:.4f} ms, skip off {t_noskip:.4f} ms")
    phase("times", f"gossip round (8 leaves, {n * d_total} f32 values): kernel {t_kernel:.4f} ms, "
                   f"plain {t_plain:.4f} ms, torch.matmul {t_lib:.4f} ms; bound {bound:.4f} ms "
                   f"(bytes {t_bytes:.4f} ms, nnz(W)={nnz} ops {t_ops:.4f} ms, "
                   f"dense ops {dense_ops_ms:.4f} ms)")

    # 5. the main path, through the entry point a user calls
    with tempfile.TemporaryDirectory() as tmp:
        spec = ExperimentSpec(**MAIN_SPEC, backend="pallas")
        store = ResultsStore(str(Path(tmp) / "main.jsonl"))
        reset_launches()
        t0 = time.perf_counter()
        out = runner.run_spec(spec, store, raise_on_error=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        records = store.curves(spec.run_id)
        eval_rounds = [r for r in range(spec.rounds)
                       if r % spec.eval_every == 0 or r == spec.rounds - 1]
        if [r["round"] for r in records] != eval_rounds:
            fail(f"records for rounds {[r['round'] for r in records]}, want {eval_rounds}")
        for r in records:
            for key in ("mean_acc", "min_acc", "g2_acc_spread", "consensus_mean"):
                if not math.isfinite(r[key]):
                    fail(f"round {r['round']}: {key} = {r[key]}")
        final = out["final"]
        if not final["mean_acc"] > 0.11:  # chance is 0.10
            fail(f"final mean_acc {final['mean_acc']} is not above chance")
        gossip_rounds = spec.rounds  # gossip_every = 1
        want = len(LEAF_D) * gossip_rounds
        if launches["gossip_mix"] != want:
            fail(f"gossip_mix launched {launches['gossip_mix']} times, want {want}")
        if final["device"] != kind or final["framework"] != "torch":
            fail(f"run_end.final says {final['framework']} on {final['device']}")
        phase("main", f"{spec.run_id}: {len(records)} records, final mean_acc "
                      f"{final['mean_acc']:.4f}, g2_acc_spread {final['g2_acc_spread']:.4f}, "
                      f"consensus_mean {final['consensus_mean']:.4f}; gossip_mix launches "
                      f"{launches['gossip_mix']} = 8 x {gossip_rounds}; {spec.rounds / wall:.3f} "
                      f"rounds/s ({wall:.2f} s, data and set-up included)")

        # Same spec, dense backend: the streamed records agree. Accuracy
        # within 3 test examples of 1000 and consensus to 1e-3: the two
        # backends sum W @ P in different orders (f32 either way), and six
        # rounds of SGD carry the rounding differences along.
        dense_spec = ExperimentSpec(**MAIN_SPEC, backend="dense")
        runner.run_spec(dense_spec, store, raise_on_error=True)
        acc_tol, cons_rtol = 3e-3, 1e-3
        for a, b in zip(records, store.curves(dense_spec.run_id)):
            for key in ("mean_acc", "min_acc", "max_acc", "g2_acc_spread"):
                if abs(a[key] - b[key]) > acc_tol:
                    fail(f"round {a['round']} {key}: pallas {a[key]} vs dense {b[key]}")
            if abs(a["consensus_mean"] - b["consensus_mean"]) > cons_rtol * b["consensus_mean"]:
                fail(f"round {a['round']} consensus: {a['consensus_mean']} vs {b['consensus_mean']}")

    # Per node: the same run through the trainer for both backends.
    per_node = {}
    for backend in ("pallas", "dense"):
        from repro_torch.core import topology
        from repro_torch.data.loader import NodeLoader
        from repro_torch.data.synthetic import make_mnist_like

        s = ExperimentSpec(**MAIN_SPEC, backend=backend)
        ds = make_mnist_like(**s.data)
        sched = topology.make_schedule(s.topology, seed=s.seed)
        parts = runner.build_partition(s, sched.graph_at(0), ds.y_train)
        loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=s.batch_size,
                            seed=s.seed + 1, device=dev)
        tr = DecentralizedTrainer(sched, loader, lr=s.lr, momentum=s.momentum,
                                  mix_impl=backend, seed=s.seed, device=dev)
        per_node[backend] = tr.run(s.rounds, eval_every=s.rounds,
                                   x_test=ds.x_test, y_test=ds.y_test)[-1]
    acc_diff = float(np.abs(per_node["pallas"].per_node_acc - per_node["dense"].per_node_acc).max())
    cons_diff = float(np.max(np.abs(per_node["pallas"].consensus - per_node["dense"].consensus)
                             / per_node["dense"].consensus))
    phase("main", f"pallas vs dense after {MAIN_SPEC['rounds']} rounds: per-node accuracy "
                  f"max diff {acc_diff:.4f} (tol {acc_tol}), consensus max rel diff "
                  f"{cons_diff:.2e} (tol {cons_rtol})")
    if acc_diff > acc_tol or cons_diff > cons_rtol:
        fail("pallas and dense backends disagree per node")

    # 6. the smoke preset's qualitative checks (recorded, not asserted)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "smoke.jsonl")
        summary = runner.run_sweep(presets.get_preset("smoke"), path)
        if summary["failed"]:
            fail(f"smoke preset runs failed: {summary['failed']}")
        checks = analysis.qualitative_checks(analysis.summarize(ResultsStore(path)))
        phase("checks", "smoke preset (seed 0): " + json.dumps(
            {k: checks.get(k) for k in ("hub_beats_edge", "hub_beats_edge_by_family",
                                        "gossip_learns_g2")}))

    print(json.dumps({"kernels": [{
        "name": "gossip_mix",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix.py:106",
        "launches": launches["gossip_mix"],
        "max_abs_err": main_err,
        "ms": t_kernel,
        "plain_ms": t_plain,
        "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": t_lib,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
