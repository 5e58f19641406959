"""The readings that a cell's limits are set from, in one process at the
cell's own size, with no timed window, for the cells of the ``mlp`` kind
(``bench/kinds/mlp.py``):

- ``sound``: the program as it is, one reading of the five numbers a seed;
- ``control``: the reference put in the program's place, computed in TF32;
- a fault (``bench/faults.py``) planted in the program.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --faults still,half --fault-seeds 7,8,9 \\
        [--out chiprun_out/calibrate.jsonl]

Each reading is one JSON line on standard output (and appended to
``--out``). The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from bench import faults, harness
    from bench.inputs import make_inputs
    from bench.kinds import mlp

    cell = harness.load_cell(args.workload)
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
    for seed, todo in roles.items():
        inputs = make_inputs(cell.config, cell.traffic, seed, devices[0])
        t0 = time.perf_counter()
        ref = mlp.reference_side(cell, inputs, devices[0])
        harness.sync(devices)
        t_ref = time.perf_counter() - t0
        for role in todo:
            t0 = time.perf_counter()
            if role == "control":
                prog = mlp.reference_side(cell, inputs, devices[0], precision="tf32")
            else:
                with faults.planted(None if role == "sound" else role):
                    prog = mlp.Run(cell, inputs, devices).prog
            harness.sync(devices)
            rec = {"cell": cell.name, "role": role, "seed": seed,
                   "numbers": mlp.gaps(prog, ref), "prog_s": time.perf_counter() - t0,
                   "reference_s": t_ref, "device": kind}
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
