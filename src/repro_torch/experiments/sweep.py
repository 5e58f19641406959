"""Sweep CLI: run a preset (or a spec-grid JSON file) through the port's runner.

    python -m repro_torch.experiments.sweep --preset smoke
    python -m repro_torch.experiments.sweep --preset paper
    python -m repro_torch.experiments.sweep --specs my_grid.json --store results/my.jsonl
    python -m repro_torch.experiments.sweep --preset churn_smoke --processes 2

Runs on the CUDA card unless ``--device cpu`` is given. Re-running the same
command is idempotent: completed runs (matched by the spec content hash) are
skipped; pass --fresh to re-run everything. After the runs, the analysis join
prints the headline tables and writes the machine-readable summary
(--bench-out, default results/torch_sweep_<preset>.json). The default store,
results/torch_sweep_<preset>.jsonl, is never the JAX package's, whose run ids
are the same.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.experiments import analysis, presets, runner
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.store import ResultsStore


def _load_specs(args: argparse.Namespace) -> list[ExperimentSpec]:
    if args.specs:
        with open(args.specs) as f:
            return [ExperimentSpec.from_json(d) for d in json.load(f)]
    return presets.get_preset(args.preset)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.experiments.sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--preset", default="smoke", choices=sorted(presets.PRESETS),
                    help="experiment matrix to run (default: smoke)")
    ap.add_argument("--specs", default="",
                    help="JSON file with a list of ExperimentSpec dicts "
                         "(overrides --preset)")
    ap.add_argument("--store", default="",
                    help="results JSONL path (default: results/torch_sweep_<preset>.jsonl)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--processes", type=int, default=1,
                    help="run specs in this many spawned worker processes, each "
                         "writing a private shard merged into the store (default 1). "
                         "On one card the workers share the device: each makes its "
                         "own CUDA context on it")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore completed runs in the store (no resume)")
    ap.add_argument("--bench-out", default=None,
                    help="machine-readable summary path "
                         "(default: results/torch_sweep_<preset>.json; '' to skip)")
    ap.add_argument("--list", action="store_true",
                    help="print the expanded run list and exit")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    specs = _load_specs(args)
    if args.list:
        for s in specs:
            print(f"{s.run_id}  {s.topology}  {s.partitioner}  seed={s.seed}")
        return 0

    # Custom spec files get their own store + label, never the preset's.
    matrix_name = (
        os.path.splitext(os.path.basename(args.specs))[0] if args.specs
        else args.preset
    )
    store_path = args.store or f"results/torch_sweep_{matrix_name}.jsonl"
    bench_out = (
        f"results/torch_sweep_{matrix_name}.json" if args.bench_out is None
        else args.bench_out
    )
    verbose = not args.quiet
    summary = runner.run_sweep(
        specs, store_path, resume=not args.fresh, processes=args.processes,
        verbose=verbose, device=args.device,
    )
    print(
        f"sweep done: {summary['ran']} ran, {summary['skipped']} skipped "
        f"(resume), {len(summary['failed'])} failed -> {summary['store']}"
    )
    for rid in summary["failed"]:
        print(f"  FAILED: {rid}")

    store = ResultsStore(store_path)
    rows = analysis.summarize(store)
    if verbose:
        print()
        print(analysis.render_tables(rows))
    if bench_out:
        os.makedirs(os.path.dirname(bench_out) or ".", exist_ok=True)
        bench = analysis.write_bench(
            store, bench_out, rows=rows, extra={"preset": matrix_name}
        )
        print(f"\nwrote {bench_out} ({bench['runs']} runs)")
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
