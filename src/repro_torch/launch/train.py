"""Decentralized LLM-cohort training: a thin CLI over the experiment
runner (model kind "lm"). The port of ``repro/launch/train.py``: the same
flags and defaults, plus ``--device``.

The CLI builds one ExperimentSpec (the reference's run id for the same
flags) and hands it to ``runner.run_spec``, so single runs land in the same
results-store format as sweeps (``--store``, default
results/torch_train_runs.jsonl). By default the members are the arch's
``.reduced()`` config in f32; ``--full-scale`` keeps its own widths and
bf16 params (llama3.2-1b at ``--nodes 2`` with CHOCO on peaks at 52.7 GiB
on an NVIDIA H100 80GB HBM3 at 700 W; a third member does not fit on one
card).

Run:  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --steps 50
      PYTHONPATH=src python -m repro_torch.launch.train --steps 2 --device cpu

Without ``--device`` it runs on the card, and raises where there is none.
After the run it prints the kernels' launch counts, the bytes the mesh
backends moved between shards (``core.mesh.wire_bytes``) and, on the card,
the peak device memory; on a machine with several cards, each card's peak
and allocated bytes. ``--mix-backend sparse_sharded`` holds the cohort's
state sharded over the default mesh, one shard per card (``--nodes``
divisible by the cards): llama3.2-1b at ``--full-scale`` trains 8 members
on four cards.
"""

from __future__ import annotations

import argparse

from repro_torch.core import decavg
from repro_torch.experiments import runner
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.store import ResultsStore

_DESCRIPTION = (
    "Train an LLM cohort with DecAvg gossip. The reference's docstring "
    "documents a --lower-only flag that its parser never defines, so neither "
    "CLI has it; the full-scale step's shape and memory dry-run is "
    "python -m repro_torch.launch.dryrun."
)


def _parse_compress(value: str):
    """--compress flag: 'auto' (default), 'none'/'off', or a top-k fraction."""
    if value == "auto":
        return "auto"
    if value in ("none", "off"):
        return None
    return float(value)


def build_spec(args: argparse.Namespace) -> ExperimentSpec:
    """One LM-cohort ExperimentSpec from the CLI flags.

    Non-default execution knobs (compress/fused/resume) are only added to
    the model dict when set, so run ids match the reference's.
    """
    model = {
        "kind": "lm",
        "arch": args.arch,
        "nodes": args.nodes,
        "batch": args.batch,
        "seq": args.seq,
        "schedule": args.schedule,
        "full_scale": bool(args.full_scale),
        "ckpt_every": args.ckpt_every,
        "ckpt_path": args.ckpt_path,
    }
    compress = _parse_compress(args.compress)
    if compress != "auto":
        model["compress"] = compress
    if not args.fused:
        model["fused"] = False
    if args.resume:
        model["resume"] = True
    return ExperimentSpec(
        topology=args.topology,
        partitioner="iid",  # LM cohorts share the token stream (tokens.py)
        backend=args.mix_backend,
        rounds=args.steps,
        eval_every=20,
        lr=args.lr,
        gossip_every=args.gossip_every,
        faults=args.faults,
        seed=args.seed,
        model=model,
        tag="launch.train",
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train", description=_DESCRIPTION)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--topology", default="ring",
                    help="topology registry spec, e.g. 'ring', 'ba:n=8,m=2', "
                         "'er:p=0.3@regen=10' (n defaults to --nodes; "
                         "see core/topology.py for the grammar)")
    ap.add_argument("--mix-backend", default="auto",
                    choices=["auto"] + list(decavg.GossipEngine.BACKENDS),
                    help="gossip backend (auto: sparse at large N, else dense)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["const", "cosine", "wsd"])
    ap.add_argument("--gossip-every", type=int, default=1)
    ap.add_argument("--compress", default="auto",
                    help="CHOCO top-k gossip fraction in (0,1], 'none'/'off', "
                         "or 'auto' (on for members above ~1 MB of parameters)")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    help="force the per-round Python loop instead of the "
                         "fused path (CUDA graphs on the card)")
    ap.add_argument("--faults", default=None,
                    help="fault-injection spec (core/faults.py grammar)")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-path", default="results/train_ckpt.npz")
    ap.add_argument("--resume", action="store_true",
                    help="restore (params, opt, step) from --ckpt-path and "
                         "continue bit-identically from the saved round")
    ap.add_argument("--full-scale", action="store_true",
                    help="use the unreduced arch config in bf16 (llama3.2-1b: "
                         "2 members fit one 80 GB card; sparse_sharded puts 2 on each card)")
    ap.add_argument("--store", default="results/torch_train_runs.jsonl",
                    help="results JSONL (same schema as the sweep store)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    import torch

    from repro_torch.core import mesh
    from repro_torch.device import resolve_device
    from repro_torch.kernels import LAUNCHES, reset_launches

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    spec = build_spec(args)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards:
        torch.cuda.init()  # the allocator's stats of every card exist from here on
    for c in range(cards):
        torch.cuda.reset_peak_memory_stats(c)
    reset_launches()
    mesh.reset_wire_bytes()
    result = runner.run_spec(spec, ResultsStore(args.store), verbose=True, device=dev)
    final = result["final"]
    spread = final.get("g2_token_spread")
    spread_s = f"  g2_spread {spread:.4f}" if spread is not None else ""
    print(
        f"done in {final['wall_s']:.0f}s  loss {final['loss']:.4f}  "
        f"consensus {final['consensus_mean']:.3g}{spread_s}  "
        f"-> {args.store} ({result['run_id']})"
    )
    print("kernel launches " + " ".join(f"{k}={v}" for k, v in LAUNCHES.items()))
    wire = mesh.wire_bytes()
    if any(wire.values()):
        print("bytes between shards " + " ".join(f"{k}={v}" for k, v in wire.items()))
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB "
              f"on {torch.cuda.get_device_name(dev)}")
    if cards > 1:
        print("peak and allocated device memory by card " + ", ".join(
            f"cuda:{c} {torch.cuda.max_memory_allocated(c)} {torch.cuda.memory_allocated(c)}"
            for c in range(cards)))
    return result


if __name__ == "__main__":
    main()
