"""Slice D's serving side: ``CohortRouter``'s coverage table against the
reference's on the same params, the same routing picks, ``load_cohort``
giving the saved params bit for bit (the port's checkpoints and the
reference's), and ``run_serve_eval`` end to end on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_cfgbase
from repro.experiments import serve_eval as ref_serve_eval
from repro.serve import router as ref_router
from repro.train.trainer import LMCohortTrainer as RefTrainer
from repro_torch.configs import base as cfgbase
from repro_torch.convert import params_from_numpy
from repro_torch.data import tokens as tok
from repro_torch.experiments import serve_eval
from repro_torch.serve import router
from repro_torch.train.trainer import LMCohortTrainer
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small operations: one intra-op thread is faster
    for them, and keeps the suite's parallel workers from oversubscribing
    the cores. The worker's setting is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 4
TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
            vocab_size=256)


@pytest.fixture(scope="module")
def cohort():
    """A star cohort the reference trained a few rounds, and its params in
    the port."""
    ref_cfg = dataclasses.replace(ref_cfgbase.get("llama32_1b").reduced(), **TINY)
    cfg = dataclasses.replace(cfgbase.get("llama32_1b").reduced(), **TINY)
    ref = RefTrainer("star:n=4", ref_cfg, nodes=N, batch=2, seq=16, lr=3e-3, gossip_every=3,
                     compress=None, data_kwargs={"domain_frac": 0.6})
    ref.run(4, eval_every=4)
    return ref_cfg, cfg, ref, params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu")


def test_coverage_and_routes_match_the_reference(cohort):
    ref_cfg, cfg, ref, params = cohort
    r_ref = ref_router.CohortRouter(ref.params, ref_cfg, seed=0)
    r = router.CohortRouter(params, cfg, seed=0)
    np.testing.assert_allclose(r.coverage, r_ref.coverage, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(r.domains, r_ref.domains)
    for j in range(N):
        q, _ = tok.domain_query_batch(j, 2, 16, cfg.vocab_size, seed=0, query_round=2)
        assert r.classify(q[0]) == r_ref.classify(q[0]) == j
        for kw in ({"route": "best"}, {"route": "round_robin"}, {"route": 2},
                   {"route": "best", "exclude": (j,)},
                   {"route": "round_robin", "exclude": (0, 1)}):
            assert r.route(q[0], **kw) == r_ref.route(q[0], **kw), kw
    with pytest.raises(ValueError, match="every node excluded"):
        r.route(q[0], exclude=range(N))
    with pytest.raises(ValueError, match="out of range"):
        r.route(q[0], route=N)
    with pytest.raises(ValueError, match="route must be"):
        r.route(q[0], route="random")
    node = r.node_params(1)
    assert torch.equal(node["embed"], params["embed"][1])


def test_stacked_like_costs_nothing():
    cfg = cfgbase.get("llama3.2-1b")
    like = router.stacked_params_like(cfg, 8)
    assert all(x.device.type == "meta" and x.shape[0] == 8 for x in tree_leaves(like))
    assert sum(x[0].numel() for x in tree_leaves(like)) == 1_498_482_688


def test_load_cohort_gives_the_saved_params(cohort, tmp_path):
    ref_cfg, cfg, ref, params = cohort
    # The port's own checkpoint, saved by its trainer with the moments.
    t = LMCohortTrainer("star:n=4", cfg, nodes=N, batch=2, seq=16, compress=None, device="cpu")
    t.run(2, eval_every=2)
    path = str(tmp_path / "port.npz")
    t.save(path, step=2)
    got, step = router.load_cohort(path, cfg, nodes=N, device="cpu")
    assert step == 2
    for a, b in zip(tree_leaves(got), tree_leaves(t.params), strict=True):
        assert a.device.type == "cpu" and torch.equal(a, b)
    # The reference's checkpoint of its trained cohort.
    ref_path = str(tmp_path / "ref.npz")
    ref.save(ref_path, step=4)
    got, step = router.load_cohort(ref_path, cfg, nodes=N, device="cpu")
    assert step == 4
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref.params), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    r = router.CohortRouter.from_checkpoint(ref_path, cfg, nodes=N, device="cpu")
    np.testing.assert_allclose(
        r.coverage, np.asarray(ref_router._coverage(
            ref.params, ref_cfg, *map(jnp.asarray, map(np.stack, zip(*(
                tok.domain_query_batch(j, 4, 16, cfg.vocab_size, seed=0) for j in range(N))))))),
        rtol=0, atol=1e-5)


def test_serve_eval_runs_on_the_cpu(tmp_path):
    kw = dict(topology="star:n=4", nodes=4, rounds=6, gossip_every=3, queries_per_domain=2)
    out = serve_eval.run_serve_eval(**kw, store_path=str(tmp_path / "s.jsonl"), device="cpu")
    want = ref_serve_eval.run_serve_eval(**kw)
    assert set(out) == set(want) | {"framework", "device"}
    assert out["device"] == "cpu" and out["rounds"] == 6
    assert set(out["serve_acc"]) == {"best", "round_robin", "best_foreign"}
    assert all(len(v) == 8 for v in out["routed"].values())
    assert isinstance(out["checks"]["router_beats_round_robin"], bool)
    assert 0.0 <= out["hub_share_foreign"] <= 1.0
    assert serve_eval.main(["--rounds", "2", "--nodes", "4", "--topology", "star:n=4",
                            "--device", "cpu"]) in (0, 1)
