"""Runs the JAX reference's LLM cohort on ``sparse_sharded`` over 4 fake CPU
devices and saves what it did, for the port's sharded cohort to be held to.

    python tests/lm_sharded_reference.py OUT.npz

Tiny llama members (2 layers, d_model 64, vocab 256), 8 on a ring, batch 2 x
16 tokens, lr 1e-3, CHOCO at k = 1 (every entry sent: the references are
kept, and no top-k near-tie can order two packages' choices apart). After
``run(2)`` every params, AdamW moment and CHOCO reference leaf must be laid
out ``PartitionSpec('data')`` over the 4 devices: the script exits non-zero
otherwise. Saves the initial and final params (``init/i``, ``final/i`` in
``jax.tree.leaves`` order) and the records' losses.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from repro.configs import base as cfgbase  # noqa: E402
from repro.train.trainer import LMCohortTrainer  # noqa: E402

TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
            vocab_size=256)


def main(out: str) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    cfg = dataclasses.replace(cfgbase.get("llama32_1b").reduced(), **TINY)
    tr = LMCohortTrainer("ring:n=8", cfg, nodes=8, batch=2, seq=16, lr=1e-3,
                         backend="sparse_sharded", compress=1.0)
    init = [np.asarray(x) for x in jax.tree.leaves(tr.params)]
    hist = tr.run(2)
    trees = {"params": tr.params, "mu": tr.opt_state.mu, "nu": tr.opt_state.nu,
             "reference": tr.cstate.reference}
    for name, tree in trees.items():
        for leaf in jax.tree.leaves(tree):
            s = leaf.sharding
            ok = (isinstance(s, NamedSharding) and s.spec == PartitionSpec("data")
                  and s.mesh.shape == {"data": 4})
            if not ok:
                sys.exit(f"{name} leaf {leaf.shape} laid out {s}")
    final = [np.asarray(x) for x in jax.tree.leaves(tr.params)]
    np.savez(out, losses=np.array([r["loss"] for r in hist]),
             **{f"init/{i}": x for i, x in enumerate(init)},
             **{f"final/{i}": x for i, x in enumerate(final)})
    print("OK", len(init), "leaves, every params, moment and reference leaf PartitionSpec('data')")


if __name__ == "__main__":
    main(sys.argv[1])
