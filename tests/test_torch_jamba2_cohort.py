"""The reduced Jamba2-3B member trained as a DecAvg cohort through the port's
LM path (``LMCohortTrainer``, ``experiments.runner``) on the benchmark cell's
shape cut down: three members on a star, one row of tokens each, ``sparse``,
no compression. ``run`` and ``run_fused`` agree bit for bit, and both hold
to the plain reference's rounds (``tests/jamba_reference.py``). One
intra-op thread, the CPU, no JAX.
"""

import numpy as np
import pytest
import torch

import jamba_reference as R
from repro_torch.configs import base as cfgbase
from repro_torch.data import tokens as tok
from repro_torch.experiments import runner
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.store import ResultsStore
from repro_torch.train.trainer import LMCohortTrainer
from repro_torch.tree import tree_leaves

KW = dict(nodes=3, batch=1, seq=16, lr=0.5, backend="sparse", compress=None, seed=7,
          device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _cfg():
    return cfgbase.get("jamba2-3b").reduced()


def test_run_and_run_fused_agree_on_the_reduced_member():
    """Three rounds, the last one recorded: params, momenta and each
    member's last losses equal to the bit (the fused path runs the same
    operations eagerly on the CPU)."""
    loop = LMCohortTrainer("star:n=3", _cfg(), **KW)
    fused = LMCohortTrainer("star:n=3", _cfg(), **KW)
    assert loop.supports_fused and loop.compress is None
    h1 = loop.run(3, eval_every=3)
    h2 = fused.run_fused(3, eval_every=3)
    assert [r["round"] for r in h1] == [r["round"] for r in h2] == [0, 2]
    for a, b in zip(tree_leaves(loop.params), tree_leaves(fused.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(loop.opt_state), tree_leaves(fused.opt_state)):
        assert torch.equal(a, b)
    assert torch.equal(loop.node_losses, fused.node_losses)
    assert h1[-1]["loss"] == h2[-1]["loss"] == pytest.approx(float(fused.node_losses.mean()))
    assert "lm_head" not in fused.params  # tied: one embedding leaf mixed


def test_a_run_with_nothing_to_record_is_one_chunk(monkeypatch):
    """``eval_every=None``: neither run path evaluates nor records, the fused
    run draws one token slab for all its rounds (one chunk), and the state
    equals, bit for bit, that of a fused run recording rounds 0 and 2."""
    recorded = LMCohortTrainer("star:n=3", _cfg(), **KW)
    assert [r["round"] for r in recorded.run_fused(3, eval_every=2)] == [0, 2]
    loop = LMCohortTrainer("star:n=3", _cfg(), **KW)
    fused = LMCohortTrainer("star:n=3", _cfg(), **KW)
    slabs, evals = [], []
    slab = tok.round_token_slab
    monkeypatch.setattr(tok, "round_token_slab",
                        lambda n, rounds, *a, **k: slabs.append(list(rounds)) or slab(
                            n, rounds, *a, **k))
    monkeypatch.setattr(LMCohortTrainer, "domain_metrics", lambda self: evals.append(1) or {})
    assert loop.run(3, eval_every=None) == [] and fused.run_fused(3, eval_every=None) == []
    assert slabs == [[0, 1, 2]] and evals == []
    for tr in (loop, fused):
        for a, b in zip(tree_leaves(recorded.params) + tree_leaves(recorded.opt_state),
                        tree_leaves(tr.params) + tree_leaves(tr.opt_state)):
            assert torch.equal(a, b)
        assert torch.equal(recorded.node_losses, tr.node_losses)


def test_the_cohort_holds_to_the_reference_rounds():
    """Two rounds from the trainer's own init (round 0's rate is 0, so round
    1 is the first that moves): each member's losses within 1e-5, and every
    leaf's params and momentum within 1e-4 of that leaf's largest entry."""
    cfg = _cfg()
    tr = LMCohortTrainer("star:n=3", cfg, **KW)
    init = {k: v for k, v in zip(_paths(tr.params), (x[0].clone() for x in tree_leaves(tr.params)))}
    losses = []
    tr.run_fused(2, eval_every=1, on_round=lambda rec: losses.append(tr.node_losses.clone()))
    toks, labels = tok.round_token_slab(3, range(2), 1, KW["seq"], cfg.vocab_size, seed=KW["seed"])
    batches = [(torch.as_tensor(toks[r]), torch.as_tensor(labels[r])) for r in range(2)]
    w = R.eq1_matrix(tr.graph.adj)
    np.testing.assert_allclose(w, tr.engine.w.cpu().numpy(), rtol=0, atol=1e-7)
    lrs = [float(tr._sched(r)) for r in range(2)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(R.cosine_lr(KW["lr"], 2, 1), rel=1e-6)
    ref = R.cohort_rounds(_tree(init), cfg, w, batches, lrs)
    np.testing.assert_allclose(torch.stack(losses).numpy(), np.array(ref["losses"]), rtol=0,
                               atol=1e-5)
    for (path, got), (_, mom) in zip(zip(_paths(tr.params), tree_leaves(tr.params)),
                                     zip(_paths(tr.opt_state), tree_leaves(tr.opt_state))):
        want = torch.stack([_at(ref["params"][i], path) for i in range(3)])
        want_m = torch.stack([_at(ref["momentum"][i], path) for i in range(3)])
        scale, scale_m = float(want.abs().max()), float(want_m.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)
        torch.testing.assert_close(mom, want_m, rtol=0, atol=1e-4 * max(scale_m, 1e-12))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _paths(v, prefix + (k,))
        return out
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree(flat):
    out: dict = {}
    for path, t in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def test_the_runner_runs_the_cells_spec_fused(tmp_path):
    """``experiments.runner``'s LM path with the benchmark cell's model keys
    (reduced here: ``full_scale`` off, 16 tokens) stages ``run_fused`` on
    ``sparse`` with no compression."""
    spec = ExperimentSpec(topology="star:n=3", backend="sparse", rounds=2, eval_every=2,
                          lr=0.5, seed=3,
                          model={"kind": "lm", "arch": "jamba2-3b", "full_scale": False,
                                 "nodes": 3, "batch": 1, "seq": 16, "compress": None})
    out = runner.run_spec(spec, ResultsStore(str(tmp_path / "r.jsonl")), device="cpu")
    assert out["status"] == "completed"
    final = out["final"]
    assert (final["fused"], final["backend"], final["compress"]) == (True, "sparse", None)
    assert np.isfinite(final["loss"]) and final["round"] == 1
