"""How robust the ``lm_smoke`` gate is: the preset's grid for seeds 0-9.

The preset (``experiments/presets.py::_lm_smoke``) runs ring:n=4 and
star:n=4 gossip and ring:n=4 isolation (``gossip_every=0``) for seeds 0 and
1, and its gate, ``lm_gossip_spreads``, holds when the gossiped runs' mean
final ``g2_token_spread`` exceeds the isolated runs' mean. This script runs
the same grid, as written, for each seed it is given, and prints for every
seed and for every pair of seeds taken in order ((0, 1), (2, 3), ...; the
preset's own is (0, 1)) the margin ``lm_gossip_g2_token_spread -
lm_isolated_g2_token_spread`` and the gate. The last line is a JSON object
with all of them.

``--package repro_torch`` (the default) runs the port, on the card unless
``--device cpu``; ``--package repro`` runs the JAX reference (on the CPU,
``JAX_PLATFORMS=cpu``). The two draw their initial weights and batches
differently, so their margins are not the same numbers.

Run from the repo root:
``PYTHONPATH=src python tools/lm_smoke_seeds.py [--seeds 0 1 ...] [--out FILE]``
``PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_smoke_seeds.py --package repro --processes 3``
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import tempfile
import time
from pathlib import Path


def margins(package: str, seeds: list[int], processes: int, device: str | None) -> dict:
    """Per seed and per seed pair: gossiped and isolated spreads, margin, gate."""
    presets = importlib.import_module(f"{package}.experiments.presets")
    runner = importlib.import_module(f"{package}.experiments.runner")
    analysis = importlib.import_module(f"{package}.experiments.analysis")
    store_mod = importlib.import_module(f"{package}.experiments.store")
    grid = [s for s in presets.get_preset("lm_smoke") if s.seed == 0]
    specs = [dataclasses.replace(s, seed=seed) for seed in seeds for s in grid]
    kw = {} if package == "repro" else {"device": device}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "lm_smoke_seeds.jsonl")
        t0 = time.perf_counter()
        summary = runner.run_sweep(specs, path, processes=processes, **kw)
        wall = time.perf_counter() - t0
        if summary["failed"]:
            raise SystemExit(f"lm_smoke seeds: {summary['failed']} runs failed")
        rows = analysis.summarize(store_mod.ResultsStore(path))

    def gate(chosen: set[int]) -> dict:
        checks = analysis.qualitative_checks([r for r in rows if r["seed"] in chosen])
        g, i = checks["lm_gossip_g2_token_spread"], checks["lm_isolated_g2_token_spread"]
        return {"gossip": g, "isolated": i, "margin": g - i, "gate": checks["lm_gossip_spreads"]}

    per_seed = {s: gate({s}) for s in seeds}
    pairs = {f"{a},{b}": gate({a, b}) for a, b in zip(seeds[::2], seeds[1::2])}
    return {"package": package, "runs": len(specs), "wall_s": wall,
            "per_seed": per_seed, "per_pair": pairs,
            "every_pair_true": all(p["gate"] for p in pairs.values())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("repro_torch", "repro"), default="repro_torch")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(10)))
    ap.add_argument("--processes", type=int, default=1)
    ap.add_argument("--device", default=None, help="the port's device; default: the CUDA card")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    out = margins(args.package, args.seeds, args.processes, args.device)
    for name, group in (("seed", out["per_seed"]), ("seeds", out["per_pair"])):
        for key, r in group.items():
            print(f"[lm_smoke {args.package}] {name} {key}: gossip {r['gossip']!r}, "
                  f"isolated {r['isolated']!r}, margin {r['margin']!r}, gate {r['gate']}")
    print(f"[lm_smoke {args.package}] {out['runs']} runs in {out['wall_s']:.2f} s; every seed "
          f"pair's gate true: {out['every_pair_true']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
