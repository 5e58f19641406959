"""One-off readings of the full-width LLM-cohort path on a CUDA card (not part
of chip_smoke.py, which asserts the path; these explain two of its choices).

1. ``launch.train --full-scale --nodes 2 --steps 4 --mix-backend pallas`` at
   the CLI's default lr (3e-4): each record's loss.
2. A same-batch probe: two AdamW steps of a freshly drawn full-width cohort
   (dense, no compression) at 3e-5 and at 3e-4, the loss of both members on
   batch 0 before and after each step (step 1 on batch 0, step 2 on batch 1).
3. torch.profiler over one full-width forward+backward of both members: the
   device's summed kernel time, the kernel count and the kernels that take
   most of it.

Run from the repo root: ``python3 tools/lm_full_probe.py``. Needs one card
with about 60 GB free; prints the card's name and power limit first.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
LRS = (3e-5, 3e-4)


def default_lr_run(smi: str) -> None:
    from repro_torch.experiments.store import ResultsStore

    with tempfile.TemporaryDirectory() as tmp:
        store_path = str(Path(tmp) / "train.jsonl")
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
               "--full-scale", "--nodes", "2", "--topology", "ring", "--steps", "4",
               "--mix-backend", "pallas", "--store", store_path]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=ROOT,
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            sys.exit(f"launch.train exited {res.returncode}:\n{res.stderr[-4000:]}")
        (rid, _), = ResultsStore(store_path).finals().items()
        losses = [(r["round"], r["loss"], r["lr"]) for r in ResultsStore(store_path).curves(rid)]
        print(f"default lr 3e-4, pallas: (round, loss, lr) {losses}; {smi}", flush=True)


def lr_probe(dev, smi: str) -> None:
    from repro_torch.configs import base as cfgbase
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import LMCohortTrainer
    from repro_torch.tree import tree_leaves

    tr = LMCohortTrainer("ring", cfgbase.get("llama3.2-1b"), nodes=2, backend="dense",
                         compress=None, device=dev)
    init = [x.clone() for x in tree_leaves(tr.params)]
    (t0, l0), (t1, l1) = tr._batch(0), tr._batch(1)

    def loss():
        with torch.no_grad():
            return "/".join(f"{float(x):.4f}" for x in tr._per_node(tr.params, t0, l0, tr._loss_fn))

    for lr in LRS:
        for d, s in zip(tree_leaves(tr.params), init):
            d.copy_(s)
        tr.opt_state = None
        tr.opt_state = adamw.init(tr.params)
        before = loss()
        tr._local_step(t0, l0, torch.tensor(lr, device=dev))
        one = loss()
        tr._local_step(t1, l1, torch.tensor(lr, device=dev))
        print(f"same-batch probe, lr {lr:g}: member losses on batch 0 {before} before, {one} "
              f"after step 1 (on batch 0), {loss()} after step 2 (on batch 1); {smi}", flush=True)
    del tr, init
    gc.collect()
    torch.cuda.empty_cache()


def profile_forward_backward(dev, smi: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import base as cfgbase
    from repro_torch.train.trainer import LMCohortTrainer
    from repro_torch.tree import tree_unflatten
    from repro_torch.tree import tree_leaves

    tr = LMCohortTrainer("ring", cfgbase.get("llama3.2-1b"), nodes=2, backend="pallas",
                         device=dev)
    toks, labels = tr._batch(0)

    def fwd_bwd():
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tr.params)]
        with torch.enable_grad():
            losses = tr._per_node(tree_unflatten(tr.params, leaves), toks, labels, tr._loss_fn)
            return torch.autograd.grad(losses.sum(), leaves)

    fwd_bwd()  # the first call pays lazy initialisation
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grads = fwd_bwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del grads
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    if not rows:
        print(f"forward+backward: the profiler saw no device time ({wall_ms:.1f} ms); {smi}")
        return
    busy_ms = sum(r[1] for r in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:8]
    print(f"forward+backward of 2 members under torch.profiler: host wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, {sum(r[2] for r in rows)} kernels; top: "
          + "; ".join(f"{k[:70]} x{c} {t / 1e3:.1f} ms" for k, t, c in top) + f"; {smi}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_full_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    default_lr_run(smi)
    lr_probe(dev, smi)
    profile_forward_backward(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
