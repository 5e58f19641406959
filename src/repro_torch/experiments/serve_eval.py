"""Serve-eval: does topology-aware routing beat topology-blind serving?
The port of ``repro/experiments/serve_eval.py``.

Trains a small LM cohort with gossip on a hub topology, checkpoints it,
reloads it through the serving stack (params-only restore -> CohortRouter),
and replays a stream of domain-tagged queries under each routing policy:

- ``best``          -- coverage-table argmax (the topology-aware router)
- ``round_robin``   -- the topology-blind baseline
- ``best_foreign``  -- "best" with the query's domain owner excluded: the
  router must know who else absorbed that domain through gossip (on a
  star, the hub).

Serve accuracy is the trainer's ``domain_acc`` quantity (mean true-next-token
probability of the routed node's model on the query), measured on held-out
query streams (``query_round=1``; the router's coverage table is built on
stream 0). Run::

    python -m repro_torch.experiments.serve_eval --store results/torch_serve_eval.jsonl
    python -m repro_torch.experiments.serve_eval --rounds 20 --device cpu

It runs on the card unless ``--device`` says otherwise, and exits 0 iff
coverage routing beats round-robin.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any

import numpy as np
import torch

__all__ = ["run_serve_eval", "main"]


def run_serve_eval(
    *,
    topology: str = "star:n=6",
    nodes: int = 6,
    rounds: int = 200,
    batch: int = 2,
    seq: int = 32,
    arch: str = "llama3.2-1b",
    seed: int = 0,
    lr: float = 3e-3,
    gossip_every: int = 8,
    domain_frac: float = 0.6,
    queries_per_domain: int = 4,
    store_path: str | None = None,
    ckpt_path: str | None = None,
    verbose: bool = False,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Train -> checkpoint -> route -> score. Returns the summary record."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.data import tokens as tok
    from repro_torch.device import device_name, resolve_device
    from repro_torch.serve.router import CohortRouter, _coverage
    from repro_torch.train.trainer import LMCohortTrainer

    dev = resolve_device(device)
    cfg = cfgbase.get(arch)
    cfg = dataclasses.replace(cfg.reduced(), param_dtype="float32", optimizer=cfg.optimizer)

    # Sparse gossip (every 8 rounds by default) keeps nodes specialized:
    # every-round DecAvg on a star converges the cohort to consensus, and a
    # homogeneous cohort has nothing for a router to exploit.
    trainer = LMCohortTrainer(
        topology, cfg, nodes=nodes, batch=batch, seq=seq, lr=lr,
        backend="dense", compress=None, seed=seed, gossip_every=gossip_every,
        data_kwargs={"domain_frac": domain_frac}, device=dev,
    )
    run = trainer.run_fused if trainer.supports_fused else trainer.run
    run(rounds, eval_every=rounds, verbose=verbose)

    tmp = None
    if ckpt_path is None:
        tmp = tempfile.mkdtemp(prefix="serve_eval_")
        ckpt_path = os.path.join(tmp, "cohort.npz")
    trainer.save(ckpt_path, step=rounds)

    # Serving side: params-only load + coverage table (query stream 0).
    router = CohortRouter.from_checkpoint(ckpt_path, cfg, nodes=nodes, seed=seed, device=dev)

    # Held-out query stream (query_round=1) and its exact (node, domain)
    # accuracy table: every policy is scored from the same measurements.
    qt, ql = zip(*(
        tok.domain_query_batch(j, queries_per_domain, seq, cfg.vocab_size, seed=seed,
                               query_round=1)
        for j in range(nodes)
    ))
    acc = _coverage(router.params, cfg, torch.as_tensor(np.stack(qt), device=dev),
                    torch.as_tensor(np.stack(ql), device=dev)).cpu().numpy()

    # Replay a shuffled query stream (a domain-ordered replay would hand
    # round-robin an accidental perfect alignment). Classification uses the
    # query tokens; scoring uses the measured accuracy table.
    rng = np.random.default_rng(seed + 1)
    stream = rng.permutation(np.repeat(np.arange(nodes), queries_per_domain))
    picks: dict[str, list[int]] = {"best": [], "round_robin": [], "best_foreign": []}
    scores: dict[str, list[float]] = {k: [] for k in picks}
    for i, j in enumerate(stream):
        q = qt[j][i % queries_per_domain]
        for pol, kw in (
            ("best", {"route": "best"}),
            ("round_robin", {"route": "round_robin"}),
            ("best_foreign", {"route": "best", "exclude": (int(j),)}),
        ):
            n = router.route(q, **kw)
            picks[pol].append(n)
            scores[pol].append(float(acc[n, j]))
    serve_acc = {pol: float(np.mean(s)) for pol, s in scores.items()}
    # On a star (node 0 = hub), how often owner-excluded routing picks the hub.
    hub_share = float(np.mean([n == 0 for n in picks["best_foreign"]]))

    summary = {
        "kind": "serve_eval",
        "topology": topology,
        "nodes": nodes,
        "rounds": rounds,
        "arch": cfg.arch_id,
        "seed": seed,
        "serve_acc": {k: round(v, 6) for k, v in serve_acc.items()},
        "routed": picks,
        "hub_share_foreign": hub_share,
        "g2_token_spread": trainer.domain_metrics().get("g2_token_spread"),
        "framework": "torch",
        "device": device_name(dev),
        "checks": {
            "router_beats_round_robin": serve_acc["best"] > serve_acc["round_robin"],
        },
    }
    if store_path:
        from repro_torch.experiments.store import ResultsStore

        store = ResultsStore(store_path)
        run_id = f"serve_eval-{topology}-s{seed}"
        store.run_start(run_id, {"kind": "serve_eval", "topology": topology,
                                 "nodes": nodes, "rounds": rounds, "seed": seed})
        store.run_end(run_id, "completed", final=summary)
    return summary


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="repro_torch.experiments.serve_eval",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--topology", default="star:n=6")
    ap.add_argument("--nodes", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store", default=None)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    summary = run_serve_eval(
        topology=args.topology, nodes=args.nodes, rounds=args.rounds,
        seed=args.seed, store_path=args.store, verbose=args.verbose, device=args.device,
    )
    print(json.dumps(summary, indent=2, default=str))
    return 0 if summary["checks"]["router_beats_round_robin"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
