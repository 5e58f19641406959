"""How far two LLM cohorts whose mixes differ only by rounding drift apart
under AdamW, read on the JAX reference (CPU).

The run is chip_smoke.py phase 16's reduced ring:n=4 member: llama3.2-1b
reduced (2 layers, d_model 256, vocab 512) in f32, 4 nodes, batch 2, seq
32, lr 1e-3 (cosine), compress off, backend dense. Each seed trains it for 3
and for 6 rounds: with the reference's own mix; with every gossip round's
mixed params multiplied by (1 + eps u), u uniform in [-1, 1], for eps 1e-7
(about one f32 rounding step) and 1e-6; and with the mix computed in f64
and rounded to f32 (another order of summation). It prints, per seed and
horizon, the largest difference of any parameter from the unperturbed run,
and the largest difference of the round-0 mix itself.

Run from the repo root:
``PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_backend_gap.py [--seeds 0 1 2]``.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import base as cfgbase
from repro.train.trainer import LMCohortTrainer

VARIANTS = (("ulp", 1e-7), ("ulp", 1e-6), ("f64", 0.0))


def cfg_reduced():
    cfg = cfgbase.get("llama3.2-1b")
    return dataclasses.replace(cfg.reduced(), param_dtype="float32", optimizer=cfg.optimizer)


def train(seed: int, rounds: int, variant: str, eps: float = 0.0) -> tuple[list[np.ndarray], float]:
    """Params after ``rounds`` rounds, and the largest change the variant
    made to the round-0 mix."""
    tr = LMCohortTrainer("ring:n=4", cfg_reduced(), nodes=4, batch=2, seq=32, lr=1e-3,
                         backend="dense", compress=None, seed=seed)
    mix, rng, first = tr.engine.mix, np.random.default_rng(seed), []

    def perturbed(params, **kw):
        out = mix(params, **kw)
        if variant == "ulp":
            new = jax.tree.map(
                lambda x: x * (1 + eps * jnp.asarray(rng.uniform(-1, 1, x.shape), x.dtype)), out)
        else:  # "f64": W @ P summed in f64, rounded to f32
            w = np.asarray(tr.engine.w, np.float64)
            new = jax.tree.map(lambda x: jnp.asarray(
                (w @ np.asarray(x, np.float64).reshape(x.shape[0], -1))
                .reshape(x.shape).astype(np.float32)), params)
        if not first:
            first.append(max(float(jnp.abs(a - b).max())
                             for a, b in zip(jax.tree.leaves(new), jax.tree.leaves(out))))
        return new

    if variant != "plain":
        tr.engine.mix = perturbed
    tr.run(rounds, eval_every=rounds)
    return [np.asarray(x) for x in jax.tree.leaves(tr.params)], (first[0] if first else 0.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    for seed in args.seeds:
        for rounds in (3, 6):
            base, _ = train(seed, rounds, "plain")
            for variant, eps in VARIANTS:
                got, first = train(seed, rounds, variant, eps)
                gap = max(float(np.abs(a - b).max()) for a, b in zip(base, got))
                name = f"x(1+{eps:g}u)" if variant == "ulp" else "in f64"
                print(f"seed {seed}, {rounds} rounds, mix {name}: round-0 mix off by "
                      f"{first:.3e}; params max abs diff {gap:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
