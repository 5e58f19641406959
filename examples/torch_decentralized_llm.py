"""End-to-end driver on the PyTorch port: decentralized training of a
transformer LM cohort.

The port of ``examples/decentralized_llm.py``. Four DecAvg nodes, each with
a domain-skewed token stream (the LLM analogue of the paper's non-IID label
split), train a ~20M-param llama-family model, gossiping weights over a
ring every step, on the CUDA card by default. The full-scale version of
this step function is what ``python -m repro_torch.launch.dryrun`` traces.

Run:  PYTHONPATH=src python examples/torch_decentralized_llm.py [--steps 300]
      PYTHONPATH=src python examples/torch_decentralized_llm.py --device cpu --steps 3 --seq 16
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as cfgbase
from repro_torch.core import decavg, topology as T
from repro_torch.data import tokens as tok
from repro_torch.device import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw
from repro_torch.tree import tree_map


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--ckpt", default=None, help="save final state here (.npz)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~20M-param member model: the assigned arch's family, small.
    cfg = dataclasses.replace(
        cfgbase.get(args.arch),
        num_layers=4,
        d_model=256,
        num_heads=8,
        num_kv_heads=4,
        head_dim=32,
        d_ff=1024,
        vocab_size=8192,
        param_dtype="float32",
        optimizer="adamw",
    )
    n = args.nodes

    # Ring topology (the classic decentralized baseline) via the registry;
    # the engine builds and validates the Eq. 1 mixing matrix.
    engine = decavg.GossipEngine(T.make("ring", n=n), device=dev)
    g, w = engine.graph, engine.w

    per_node = TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    params = tree_map(lambda x: x.expand(n, *x.shape).clone(), per_node)
    print(f"member model: {TF.param_count(per_node) / 1e6:.1f}M params x {n} nodes ({g.name}) on {dev}")
    opt = adamw.init(params)

    step_fn = ST.build_train_step(cfg, num_nodes=n, optimizer="adamw", lr=3e-4)

    data = tok.token_batches(n, args.batch, args.seq, cfg.vocab_size, steps=args.steps, seed=0)
    t0 = time.perf_counter()
    loss0 = None
    for i, (toks, labels) in enumerate(data):
        batch = {
            "tokens": torch.as_tensor(toks, device=dev)[None],  # leading microbatch axis
            "labels": torch.as_tensor(labels, device=dev)[None],
        }
        params, opt, loss = step_fn(params, opt, w, batch)
        if loss0 is None:
            loss0 = float(loss)
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}  ({time.perf_counter() - t0:.0f}s)")

    print(f"\nloss {loss0:.3f} -> {float(loss):.3f} over {args.steps} steps")
    # all ring nodes stay in consensus-ish: check parameter spread
    print(f"consensus distance across nodes: {float(decavg.gossip_error(params)):.2e}")
    if args.ckpt:
        ckpt.save(args.ckpt, {"params": params, "opt": opt._asdict()}, step=args.steps)
        print(f"saved checkpoint to {args.ckpt}")


if __name__ == "__main__":
    main()
