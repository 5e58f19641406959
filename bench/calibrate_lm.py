"""The readings that an ``lm`` cell's limits are set from, in one process at
the cell's own size, with no timed window (``bench/kinds/lm.py``):

- ``sound``: the program as it is, one reading of the three numbers a seed;
- ``control``: the reference in the program's place one precision below
  what the configuration states: its matmuls in float8 (below the bf16
  weights), its scan's state in bf16 (below the scan's f32; on the scan the
  sound run recorded);
- a fault (``lm.FAULTS``) planted in the program.

    python3 bench/calibrate_lm.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4 --faults still,gossip --fault-seeds 5,6 \\
        [--traffic '{"lr": 0.5}'] [--out calibrate_lm.jsonl]

For each seed the program runs once a role and the reference's rounds (f32)
once; the reference's scan runs on each role's recorded scan. With
``--scan-only`` the reference's rounds are left out and only ``scan`` is read
(about 30 s a seed instead of 150).
Each reading is one JSON line on standard output (and appended to
``--out``). The benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def _worst(side, ref, paths, top: int = 6) -> dict[str, list]:
    """The leaves with the widest gaps of each per-leaf number."""
    import numpy as np

    out = {}
    for name in ("momentum", "change"):
        got, want = getattr(side, name), getattr(ref, name)
        gap = np.abs(got - want) / np.maximum(want, np.median(want))
        order = np.argsort(-gap)[:top]
        out[name] = [["/".join(paths[i]), float(gap[i]), float(want[i])] for i in order]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--traffic", default="{}", help="JSON merged into the cell's traffic")
    ap.add_argument("--scan-only", action="store_true",
                    help="read the scan number alone (no replay of the rounds)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    import repro_torch.device  # noqa: F401  (TF32 off, as the program states)
    from bench import harness
    from bench.kinds import lm

    cell = harness.load_cell(args.workload, overrides=json.loads(args.traffic))
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    kind = torch.cuda.get_device_name(0)
    roles: dict[int, list[str]] = {}
    for s in _ints(args.seeds):
        roles.setdefault(s, []).append("sound")
    for s in _ints(args.control_seeds):
        roles.setdefault(s, []).append("control")
    for f in [f for f in args.faults.split(",") if f]:
        for s in _ints(args.fault_seeds):
            roles.setdefault(s, []).append(f)
    out = open(args.out, "a") if args.out else None

    def emit(rec) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def free() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    for seed, todo in roles.items():
        sides, times, run = {}, {}, None
        for role in [r for r in todo if r != "control"] or ["sound"]:
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            with lm.planted(None if role == "sound" else role):
                run = lm.Run(cell, seed, devices)
            harness.sync(devices)
            times[role] = time.perf_counter() - t0
            sides[role] = (run.prog, run.scan, torch.cuda.max_memory_allocated() / 2**30)
            run.release()
            free()
        scans = {role: lm.scan_number(scan, devices[0]) for role, (_, scan, _) in sides.items()}
        if args.scan_only:
            if "control" in todo:
                scans["control"] = lm.scan_number(sides["sound"][1], devices[0], torch.bfloat16)
            for role in todo:
                emit({"cell": cell.name, "role": role, "seed": seed,
                      "numbers": {"scan": scans[role]}, "prog_s": times.get(role), "device": kind})
            continue
        t0 = time.perf_counter()
        ref = lm.reference_side(run, devices[0])
        t_ref = time.perf_counter() - t0
        free()
        if "control" in todo:
            # The control: the reference one precision below what the
            # configuration states, the step's matmuls in float8, the
            # scan's state in bf16.
            t0 = time.perf_counter()
            sides["control"] = (lm.reference_side(run, devices[0], "fp8"), None, None)
            scans["control"] = lm.scan_number(sides.get("sound", (None, run.scan))[1],
                                              devices[0], torch.bfloat16)
            times["control"] = time.perf_counter() - t0
            free()
        for role, (side, _, peak) in sides.items():
            if role not in todo:
                continue
            numbers = {**lm.gaps(side, ref), "scan": scans[role]}
            emit({"cell": cell.name, "role": role, "seed": seed, "lr": cell.traffic["lr"],
                  "numbers": numbers, "worst_leaves": _worst(side, ref, run.paths),
                  "losses": side.losses.tolist(),
                  "ref_losses": ref.losses.tolist(), "prog_s": times[role], "peak_gib": peak,
                  "reference_s": t_ref, "device": kind})
    return 0


if __name__ == "__main__":
    sys.exit(main())
