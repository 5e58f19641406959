"""Quickstart on the PyTorch port: fully decentralized learning (DecAvg)
over an ER graph.

The port of ``examples/quickstart.py``: 30 nodes, non-IID data
(hub-focused), 30 communication rounds, on the CUDA card by default. Shows
per-node accuracy over rounds, and how knowledge about classes 5-9 (held
only by a few hub nodes) spreads.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu --nodes 10 --rounds 2
"""

import argparse

import numpy as np
import torch

from repro_torch.core import partition as P, topology as T
from repro_torch.core.mixing import decavg_matrix, spectral_gap
from repro_torch.data.loader import NodeLoader
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.train.metrics import confusion_matrix
from repro_torch.train.trainer import DecentralizedTrainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--train-per-class", type=int, default=600)
    ap.add_argument("--test-per-class", type=int, default=60)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.nodes

    print("== data ==")
    ds = make_mnist_like(train_per_class=args.train_per_class,
                         test_per_class=args.test_per_class, seed=0)
    print(f"train {ds.x_train.shape}, test {ds.x_test.shape}, {ds.num_classes} classes")

    print("\n== topology ==")
    g = T.make(f"er:n={n},p=0.15", seed=0)  # registry spec; try "ws:n=30,k=4" etc.
    print(f"{g.name}: {g.num_edges} edges, degrees {g.degrees().min()}..{g.degrees().max()}")

    parts = P.hub_focused(ds.y_train, g, seed=1)
    summ = P.partition_summary(ds.y_train, parts)
    holders = np.flatnonzero(summ[:, 5:].sum(axis=1) > 0)
    print(f"hub-focused: classes 5-9 held only by nodes {holders.tolist()}")

    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=32, seed=2, device=dev)
    w = decavg_matrix(g, loader.sizes.astype(float))
    print(f"mixing spectral gap: {spectral_gap(w):.4f}")

    print(f"\n== decentralized training (DecAvg) on {dev} ==")
    tr = DecentralizedTrainer(g, loader, lr=0.02, momentum=0.9, seed=0, device=dev)
    tr.run(args.rounds, eval_every=5, x_test=ds.x_test, y_test=ds.y_test, verbose=True)

    print("\n== knowledge spread ==")
    x_test = torch.as_tensor(ds.x_test, device=dev)
    y_test = torch.as_tensor(ds.y_test, dtype=torch.int64, device=dev)
    _accs, _gaccs, logits = tr._eval(tr.params, x_test, y_test, None)
    cms = torch.stack([confusion_matrix(lg, y_test, ds.num_classes) for lg in logits]).cpu().numpy()
    non_holders = [i for i in range(n) if i not in holders]
    g2_recall = cms[non_holders][:, 5:, :].diagonal(offset=5, axis1=1, axis2=2).mean()
    print(f"mean recall on never-seen classes 5-9 at non-holder nodes: {g2_recall:.3f}")
    print("(> 0 only because gossip carried the hubs' knowledge across the graph)")


if __name__ == "__main__":
    main()
