"""Sweep presets: the paper's matrix at several scales (copied from the JAX
package, so every spec keeps its run id).

- ``smoke``: 3 topology families, hub/edge splits on BA, 1 seed, N=16.
- ``paper``: the reproduction matrix (N=100; ER / BA / SBM x iid / hub /
  edge / community x 3 seeds).
- ``large_n``, ``large_n_smoke``: the scaling runs. ``large_n``'s six
  N=1024 runs and ``large_n_smoke``'s ``sparse`` run take the sparse
  backend; the ``sparse_sharded`` runs (``large_n``'s BA N=4096 and the
  smoke's ``@rewire`` BA N=32) run over the default mesh, one shard per
  local card (one on the CPU), with the node state sharded end to end.
  Every run takes ``run_fused``.
- ``churn_smoke``: fault injection: hub kills against leaf kills on BA N=16
  (``hub_kill_hurts_more``).
- ``lm_smoke``: LLM cohorts: ring and star gossip against isolation on
  reduced transformer members (``lm_gossip_spreads``); all runs fused.
"""

from __future__ import annotations

from repro_torch.experiments.spec import ExperimentSpec, expand_grid

__all__ = ["PRESETS", "get_preset"]


def _smoke() -> list[ExperimentSpec]:
    base = {
        "rounds": 10,
        "eval_every": 1,
        "lr": 0.05,
        "momentum": 0.9,
        "batch_size": 8,
        "backend": "dense",
        "data": {"train_per_class": 300, "test_per_class": 50},
        "tag": "smoke",
    }
    specs = expand_grid(
        base,
        topology=["ba:n=16,m=2"],
        partitioner=["hub_focused", "edge_focused"],
        seed=[0],
    )
    specs += expand_grid(
        base,
        topology=["er:n=16,p=0.35", "ws:n=16,k=4,beta=0.2"],
        partitioner=["hub_focused"],
        seed=[0],
    )
    return specs


def _paper() -> list[ExperimentSpec]:
    base = {
        "rounds": 40,
        "eval_every": 2,
        "lr": 0.05,
        "momentum": 0.9,
        "batch_size": 32,
        "backend": "dense",
        "tag": "paper",
    }
    specs = expand_grid(
        base,
        topology=["er:n=100", "ba:n=100,m=2"],
        partitioner=["iid", "hub_focused", "edge_focused"],
        seed=[0, 1, 2],
    )
    specs += expand_grid(
        base,
        topology=["sbm:n=100,blocks=4,p_in=0.5,p_out=0.01"],
        partitioner=["community"],
        seed=[0, 1, 2],
    )
    return specs


def _large_n() -> list[ExperimentSpec]:
    # Narrow member MLPs + sparse gossip with chunked segment-sum sizing:
    # this preset measures spread + wall-clock at scale, so every node still
    # needs >= 1 image per G1 class (train_per_class >= n).
    base = {
        "rounds": 5,
        "eval_every": 1,
        "lr": 0.05,
        "momentum": 0.9,
        "batch_size": 8,
        "backend": "sparse",
        "data": {"train_per_class": 2048, "test_per_class": 100},
        # sparse_p_chunk="auto" bounds the O(nnz*P) gather transient — at
        # n=4096/ba(m=2) the hidden=[64] first layer is otherwise a ~4 GB
        # intermediate per mix.
        "model": {"kind": "mlp", "hidden": [64], "sparse_p_chunk": "auto"},
        "tag": "large_n",
    }
    specs = expand_grid(
        base,
        topology=[
            "ws:n=1024,k=8,beta=0.1",
            "torus:rows=32,cols=32",
            "caveman:cliques=128,size=8",
        ],
        partitioner=["hub_focused", "edge_focused"],
        seed=[0],
    )
    # N=4096 rides the sparse_sharded backend, over the default mesh: one
    # shard per local card.
    specs += expand_grid(
        {**base, "backend": "sparse_sharded",
         "data": {"train_per_class": 5000, "test_per_class": 100}},
        topology=["ba:n=4096,m=2"],
        partitioner=["hub_focused"],
        seed=[0],
    )
    return specs


def _large_n_smoke() -> list[ExperimentSpec]:
    # Tiny-N stand-in for the large_n preset shapes, runnable in CI minutes:
    # same backends (sparse with chunking, sparse_sharded over the local
    # device mesh) and a @rewire schedule so the fused MixingProgram stages
    # multiple periods. The CI smoke-sweep job asserts the sparse_sharded
    # run's final record has fused=True — the single-compiled-program path
    # cannot silently regress to the per-round loop.
    base = {
        "rounds": 4,
        "eval_every": 2,
        "lr": 0.05,
        "momentum": 0.9,
        "batch_size": 8,
        "backend": "sparse",
        "data": {"train_per_class": 64, "test_per_class": 20},
        "model": {"kind": "mlp", "hidden": [32], "sparse_p_chunk": "auto"},
        "tag": "large_n_smoke",
    }
    specs = expand_grid(
        base,
        topology=["ws:n=32,k=4,beta=0.1"],
        partitioner=["hub_focused"],
        seed=[0],
    )
    specs += expand_grid(
        {**base, "backend": "sparse_sharded"},
        topology=["ba:n=32,m=2@rewire=2"],
        partitioner=["hub_focused"],
        seed=[0],
    )
    return specs


def _churn_smoke() -> list[ExperimentSpec]:
    # The fault subsystem's CI gate: one BA graph, hub-focused G2 data, and
    # a deterministic mid-run kill (p_leave=1, p_join=0) of the top-degree
    # quarter vs the bottom-degree quarter of nodes. Killing the hubs that
    # hold AND route G2 knowledge must damage ``g2_acc_spread`` at least as
    # much as killing leaves — the paper's centrality result under churn
    # (analysis.qualitative_checks: hub_kill_hurts_more). Both runs take the
    # fused path, so the masks ride the single lax.scan end to end.
    base = {
        "rounds": 16,
        "eval_every": 2,
        "lr": 0.05,
        "momentum": 0.9,
        "batch_size": 8,
        "backend": "dense",
        "data": {"train_per_class": 300, "test_per_class": 50},
        "tag": "churn_smoke",
    }
    return expand_grid(
        base,
        topology=["ba:n=16,m=2"],
        partitioner=["hub_focused"],
        faults=[
            "churn:p_leave=1.0,p_join=0.0,frac=0.25,start=8@targeted=hubs",
            "churn:p_leave=1.0,p_join=0.0,frac=0.25,start=8@targeted=leaves",
        ],
        seed=[0, 1],
    )


def _lm_smoke() -> list[ExperimentSpec]:
    # The LLM-cohort CI gate: reduced transformer members on domain-skewed
    # token streams (data/tokens.py), ring vs star gossip vs gossip_every=0
    # isolation over 2 seeds. The gate (analysis.qualitative_checks:
    # lm_gossip_spreads) asserts gossiped cohorts end with higher
    # g2_token_spread — each node's mean true-token probability on *other*
    # nodes' domain tokens — than isolated ones: domain knowledge moved over
    # the edges. All runs take the fused lm scan. compress is pinned off:
    # CHOCO top-k at these tiny horizons injects more reference error than
    # the 60 rounds can average away, which would mask the spread signal.
    base = {
        "rounds": 60,
        "eval_every": 30,
        "lr": 1e-3,
        "backend": "dense",
        "model": {
            "kind": "lm", "nodes": 4, "batch": 2, "seq": 32, "compress": None,
        },
        "tag": "lm_smoke",
    }
    specs = expand_grid(
        base,
        topology=["ring:n=4", "star:n=4"],
        seed=[0, 1],
    )
    specs += expand_grid(
        {**base, "gossip_every": 0},
        topology=["ring:n=4"],
        seed=[0, 1],
    )
    return specs


PRESETS = {
    "smoke": _smoke,
    "paper": _paper,
    "large_n": _large_n,
    "large_n_smoke": _large_n_smoke,
    "churn_smoke": _churn_smoke,
    "lm_smoke": _lm_smoke,
}


def get_preset(name: str) -> list[ExperimentSpec]:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; one of {sorted(PRESETS)}")
    return PRESETS[name]()
