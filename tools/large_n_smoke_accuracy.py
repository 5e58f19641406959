"""Where the ``large_n_smoke`` preset's ``sparse_sharded`` run ends in
accuracy, and why, read on the CPU.

The run is BA N=32 ``@rewire=2``, hub_focused, 4 rounds. The script prints
its final mean and max accuracy through the port's ``run_spec`` on
``sparse_sharded``, on ``sparse``, untrained (lr=0), for seeds 1-4, and for
8, 16 and 32 rounds; then the JAX reference's run of the same spec on
``sparse`` (its own random draws, so not the port's numbers).

Run from the repo root:
``PYTHONPATH=src JAX_PLATFORMS=cpu python tools/large_n_smoke_accuracy.py``.
"""

from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path

import torch


def main() -> None:
    from repro.experiments import runner as ref_runner
    from repro.experiments.store import ResultsStore as RefStore
    from repro_torch.experiments import presets, runner
    from repro_torch.experiments.store import ResultsStore

    torch.set_num_threads(1)
    (spec,) = [s for s in presets.get_preset("large_n_smoke") if s.backend == "sparse_sharded"]
    variants = [("as written", spec), ("on sparse", dataclasses.replace(spec, backend="sparse")),
                ("lr=0", dataclasses.replace(spec, lr=0.0))]
    variants += [(f"seed {s}", dataclasses.replace(spec, seed=s)) for s in range(1, 5)]
    variants += [(f"{r} rounds", dataclasses.replace(spec, rounds=r)) for r in (8, 16, 32)]
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, s) in enumerate(variants):
            final = runner.run_spec(s, ResultsStore(str(Path(tmp) / f"{i}.jsonl")),
                                    device="cpu")["final"]
            print(f"port {name:>10}: mean_acc {final['mean_acc']:.4f} max_acc {final['max_acc']:.4f}")
        ref = dataclasses.replace(spec, backend="sparse")
        final = ref_runner.run_spec(ref, RefStore(str(Path(tmp) / "ref.jsonl")))["final"]
        print(f"reference on sparse: mean_acc {final['mean_acc']:.4f} max_acc {final['max_acc']:.4f}")


if __name__ == "__main__":
    main()
