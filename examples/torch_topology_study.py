"""Mini topology study on the PyTorch port: the paper's experiment grid.

The port of ``examples/topology_study.py``, with its own copy of the grid
it takes from ``benchmarks/paper_experiments.py``: ER below, at and above
the connectivity threshold p*, BA with m = 2, 5 and 10, and SBM with p_in
0.5 and 0.8, under hub- and edge-focused non-IID splits (SBM: one split a
community), each trained with DecAvg (the paper's MLP, local SGD with lr
1e-3 and momentum 0.5, ``dense`` mixing). It prints each run's final
accuracy, the paper's Table 1 (per-community confusion matrices and
external links) for SBM, and the two qualitative orderings the paper
reports. Nothing is asserted: the orderings are printed.

Each run's record (per-round per-node accuracy beside the node's degree,
whether it holds classes 5-9, and its SBM block) goes to
``results/paper_torch/<run>.json``, beside the reference's
``results/paper/``.

Run:  PYTHONPATH=src python examples/torch_topology_study.py [--rounds 25] [--nodes 50]
      PYTHONPATH=src python examples/torch_topology_study.py --device cpu --nodes 16 --rounds 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import mixing, partition as P, topology as T
from repro_torch.data.loader import NodeLoader
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.train.metrics import community_confusion
from repro_torch.train.trainer import DecentralizedTrainer

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "results", "paper_torch")


@dataclasses.dataclass
class ExpSettings:
    nodes: int = 100
    train_per_class: int = 2000
    test_per_class: int = 100
    rounds: int = 100
    eval_every: int = 5
    batch_size: int = 32
    lr: float = 1e-3          # paper §5.1
    momentum: float = 0.5     # paper §5.1
    local_epochs: int = 3     # paper: "a number of local training epochs"
    seed: int = 0

    @classmethod
    def quick(cls) -> "ExpSettings":
        return cls(nodes=40, train_per_class=400, test_per_class=40, rounds=12, eval_every=3)


def _dataset(s: ExpSettings):
    return make_mnist_like(
        train_per_class=s.train_per_class, test_per_class=s.test_per_class, seed=s.seed
    )


def _run(name: str, g, parts, s: ExpSettings, ds, extra: dict | None = None, *, device=None):
    """Train one run and write its record; returns (record, trainer).
    ``device=None`` means the card."""
    device = resolve_device(device)
    if s.nodes != 100:  # don't clobber the full-scale (100-node) artifacts
        name = f"{name}_n{s.nodes}"
    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=s.batch_size,
                        seed=s.seed + 2, device=device)
    tr = DecentralizedTrainer(
        g, loader, lr=s.lr, momentum=s.momentum, seed=s.seed,
        local_epochs=s.local_epochs, mix_impl="dense", device=device,
    )
    t0 = time.perf_counter()
    hist = tr.run(s.rounds, eval_every=s.eval_every, x_test=ds.x_test, y_test=ds.y_test)
    elapsed = time.perf_counter() - t0
    os.makedirs(RESULTS_DIR, exist_ok=True)
    rows = []
    summ = P.partition_summary(ds.y_train, parts)
    g2_holder = (summ[:, 5:].sum(axis=1) > 0).astype(int)
    deg = g.degrees()
    for h in hist:
        for node in range(g.num_nodes):
            rows.append(
                dict(
                    round=h.round,
                    node=node,
                    acc=float(h.per_node_acc[node]),
                    degree=int(deg[node]),
                    holds_g2=int(g2_holder[node]),
                    block=int(g.blocks[node]) if g.blocks is not None else -1,
                )
            )
    out = {
        "name": name,
        "settings": dataclasses.asdict(s),
        "elapsed_s": round(elapsed, 1),
        "spectral_gap": mixing.spectral_gap(tr.w.cpu().numpy()),
        "final_mean_acc": hist[-1].mean_acc,
        "final_std_acc": hist[-1].std_acc,
        "extra": extra or {},
        "rows": rows,
    }
    with open(os.path.join(RESULTS_DIR, f"{name}.json"), "w") as f:
        json.dump(out, f)
    print(
        f"[{name}] final mean acc {hist[-1].mean_acc:.4f} std {hist[-1].std_acc:.4f} "
        f"gap {out['spectral_gap']:.4f} ({elapsed:.0f}s)"
    )
    return out, tr


def _split(focus: str):
    return P.edge_focused if focus == "edge" else P.hub_focused


def er_experiments(s: ExpSettings, *, focus_cases=("edge", "hub"), device=None):
    """Paper Fig. 1-3: ER at p in {0.03, p*=0.046, 0.05} x {edge,hub}-focused."""
    ds = _dataset(s)
    n = s.nodes
    pstar = T.er_critical_p(n)
    outs = []
    for p in (0.65 * pstar, pstar, 1.09 * pstar):  # 0.03, 0.046, 0.05 at n=100
        g = T.make(f"er:n={n},p={p}", seed=s.seed)
        for focus in focus_cases:
            parts = _split(focus)(ds.y_train, g, seed=s.seed + 1)
            outs.append(_run(f"er_p{p:.3f}_{focus}", g, parts, s, ds,
                             extra={"p": p, "focus": focus}, device=device))
    return outs


def ba_experiments(s: ExpSettings, *, focus_cases=("edge", "hub"), device=None):
    """Paper Fig. 4-6: BA at m in {2, 5, 10} x {edge,hub}-focused."""
    ds = _dataset(s)
    outs = []
    for m in (2, 5, 10):
        g = T.make(f"ba:n={s.nodes},m={m}", seed=s.seed)
        for focus in focus_cases:
            parts = _split(focus)(ds.y_train, g, seed=s.seed + 1)
            outs.append(_run(f"ba_m{m}_{focus}", g, parts, s, ds,
                             extra={"m": m, "focus": focus}, device=device))
    return outs


def sbm_experiments(s: ExpSettings, *, device=None):
    """Paper Fig. 7 + Table 1: SBM 4 communities, p_in in {0.5, 0.8}.

    Classes 8 and 9 are discarded (4 communities x 2 classes), so the test
    set is filtered to classes 0-7: the paper's 0.25 intra-community ceiling
    is 2 of 8 classes. Returns (record, Table 1's (4, 10, 10) confusion,
    external edges of each community) per run.
    """
    ds = _dataset(s)
    keep = ds.y_test < 8
    ds = dataclasses.replace(ds, x_test=ds.x_test[keep], y_test=ds.y_test[keep])
    outs = []
    sizes = "+".join([str(s.nodes // 4)] * 4)
    for p_in in (0.5, 0.8):
        g = T.make(f"sbm:sizes={sizes},p_in={p_in},p_out=0.01", seed=s.seed)
        parts = P.community(ds.y_train, g, seed=s.seed + 1)
        name = f"sbm_pin{p_in}"
        out, tr = _run(name, g, parts, s, ds, extra={"p_in": p_in}, device=device)
        # Table 1: per-community averaged confusion matrices + external links.
        cms = torch.as_tensor(tr.confusion(ds.x_test, ds.y_test))
        comm_cm = community_confusion(cms, torch.as_tensor(g.blocks), 4).numpy()
        ext = T.external_edge_counts(g).tolist()
        tname = name if s.nodes == 100 else f"{name}_n{s.nodes}"
        with open(os.path.join(RESULTS_DIR, f"{tname}_table1.json"), "w") as f:
            json.dump({"confusion": comm_cm.tolist(), "external_edges": ext}, f)
        outs.append((out, comm_cm, ext))
    return outs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--nodes", type=int, default=50)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    s = ExpSettings(
        nodes=args.nodes,
        train_per_class=800,
        test_per_class=50,
        rounds=args.rounds,
        eval_every=max(1, args.rounds // 5),
    )
    t0 = time.perf_counter()
    print(f"=== ER (paper Fig. 1-3) on {dev} ===")
    er = er_experiments(s, device=dev)
    print("\n=== BA (paper Fig. 4-6) ===")
    ba = ba_experiments(s, device=dev)
    print("\n=== SBM (paper Fig. 7 / Table 1) ===")
    sbm = sbm_experiments(s, device=dev)
    for out, comm_cm, ext in sbm:
        recall = "; ".join(" ".join(f"{x:.3f}" for x in np.diag(cm)[:8]) for cm in comm_cm)
        print(f"[{out['name']}] Table 1: external edges by community {ext}; "
              f"recall of classes 0-7 by community: {recall}")

    print("\n=== qualitative claims ===")
    hub = [o["final_mean_acc"] for o, _ in er + ba if o["extra"]["focus"] == "hub"]
    edge = [o["final_mean_acc"] for o, _ in er + ba if o["extra"]["focus"] == "edge"]
    print(f"(i/ii) hub-focused mean acc {sum(hub)/len(hub):.4f} "
          f"vs edge-focused {sum(edge)/len(edge):.4f}  -> hubs spread knowledge better")
    acc = {o[0]["extra"]["p_in"]: o[0]["final_mean_acc"] for o in sbm}
    print(f"(iv) SBM p_in=0.5 acc {acc[0.5]:.4f} vs p_in=0.8 {acc[0.8]:.4f} "
          f"-> tighter communities hinder spread")
    print(f"{len(er) + len(ba) + len(sbm)} runs on {dev} in {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
