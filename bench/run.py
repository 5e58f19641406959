"""The benchmark's one command: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, builds the program as the configuration's kind of run says
(``bench/kinds/<kind>.py``), warms up with one full call (set-up ends there),
measures for ``--seconds``, replays the set-up's call with the plain
reference, and prints one JSON line as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics) and ``device``; with
``--trace 1`` also ``breakdown``; and last, ``checked``: each compared
number beside its limit, which also close standard error.

It needs the cell's CUDA cards and exits non-zero, printing no result,
without them, when the program cannot be imported, or when JAX or the JAX
package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache of the program at a fixed path inside the checkout.
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "4")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative integer")

    import torch

    torch.set_num_threads(4)
    from bench import harness

    out = harness.run(args.workload, seed=args.seed, seconds=args.seconds,
                      traced=bool(args.trace), t_start=T_START)
    print(json.dumps(_finite(out)), flush=True)
    return 0


def _finite(x):
    """``x`` with every NaN or infinity as null, so that the line stays
    JSON (such a number never passes its limit)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
