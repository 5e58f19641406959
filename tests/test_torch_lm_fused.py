"""Slice D's fused path and checkpoints, in the port: ``run_fused`` against
``run`` at the reference's 1e-6 (tests/test_lm_fused.py) across cadences,
a rewiring schedule, CHOCO, faults and stragglers; dead nodes' params and
both moments frozen to the bit; ``(params, opt[, cstate])`` checkpoints
resumed bit-identically on both paths, and readable by the reference."""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import base as cfgbase
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


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(
        cfgbase.get("llama32_1b").reduced(),
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=256,
    )


def make(cfg, topology="ring:n=4", **kw):
    kw.setdefault("seed", 0)
    return LMCohortTrainer(topology, cfg, nodes=N, batch=2, seq=16, lr=1e-3, device="cpu", **kw)


def close(a, b, atol):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=atol)


def equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("topology,kw,rounds", [
    ("ring:n=4", {}, 7),
    ("ring:n=4", {"gossip_every": 2}, 7),
    ("er:n=4,p=0.6@rewire=2", {"seed": 1}, 6),
    ("ring:n=4", {"compress": 0.25}, 6),
    ("ring:n=4", {"compress": 0.25, "gossip_every": 2}, 7),
    ("ring:n=4", {"faults": "churn:p_leave=0.4,p_join=0.3"}, 6),
    ("ring:n=4", {"faults": "churn:p_leave=0.3,p_join=0.3;straggler:frac=0.3,delay=2"}, 6),
    ("ring:n=4", {"backend": "sparse", "faults": "churn:p_leave=0.3,p_join=0.3;"
                                                   "straggler:frac=0.3,delay=2"}, 6),
    ("ring:n=4", {"backend": "sparse_pallas"}, 6),
    ("ring:n=4", {"schedule": "wsd", "gossip_every": 0}, 5),
])
def test_fused_matches_the_loop(cfg, topology, kw, rounds):
    t1, t2 = make(cfg, topology, **kw), make(cfg, topology, **kw)
    h1, h2 = t1.run(rounds, eval_every=3), t2.run_fused(rounds, eval_every=3)
    close(t1.params, t2.params, 1e-6)
    assert [r["round"] for r in h1] == [r["round"] for r in h2]
    for a, b in zip(h1, h2):
        assert set(a) == set(b)
        assert a["loss"] == pytest.approx(b["loss"], abs=1e-6)
        assert a["lr"] == pytest.approx(b["lr"], abs=1e-9)
        assert a.get("alive_count") == b.get("alive_count")
    if t1.cstate is not None:
        close(t1.cstate.reference, t2.cstate.reference, 1e-6)


def test_pallas_is_loop_only(cfg):
    t = make(cfg, backend="pallas")
    assert not t.supports_fused
    with pytest.raises(ValueError, match="run_fused supports"):
        t.run_fused(2)
    assert make(cfg, backend="sparse").supports_fused


KILL = "churn:p_leave=1.0,p_join=0.0,frac=0.5@targeted=hubs"


@pytest.mark.parametrize("path", ["run", "run_fused"])
def test_dead_nodes_bit_frozen(cfg, path):
    """Nodes killed at round 0 and never back keep their params and both
    AdamW moments to the bit; the shared step count advances; the others
    train."""
    t = make(cfg, faults=KILL)
    trace = t.engine.fault_trace
    trace.ensure(4)
    alive = trace.alive_matrix(4)
    dead, live = np.flatnonzero(~alive.any(axis=0)), np.flatnonzero(alive.all(axis=0))
    assert dead.size and live.size
    before = [x.clone() for x in tree_leaves(t.params) + tree_leaves(t.opt_state)]
    getattr(t, path)(4, eval_every=4)
    after = tree_leaves(t.params) + tree_leaves(t.opt_state)
    for a, b in zip(before, after):
        if a.dim() == 0:
            assert int(b) == int(a) + 4  # AdamW's count
            continue
        assert torch.equal(a[dead], b[dead])
    assert any(not torch.equal(a[live], b[live]) for a, b in zip(before, after) if a.dim())


# -- checkpoints -----------------------------------------------------------------

def test_ckpt_rounds_include_final():
    assert LMCohortTrainer._ckpt_rounds(10, 0) == set()
    assert LMCohortTrainer._ckpt_rounds(10, 3) == {3, 6, 9}
    assert LMCohortTrainer._ckpt_rounds(10, 4) == {4, 8, 9}


@pytest.mark.parametrize("compress", [None, 0.25])
def test_checkpoint_carries_opt_cstate_and_step(cfg, tmp_path, compress):
    path = str(tmp_path / "lm.ckpt")
    t = make(cfg, compress=compress)
    t.run(4, eval_every=4, ckpt_every=3, ckpt_path=path)
    t2 = make(cfg, compress=compress)
    assert t2.restore(path) == 4  # the final round, 3, was saved
    equal(t.params, t2.params)
    equal(t.opt_state, t2.opt_state)
    assert type(t2.opt_state).__name__ == "AdamWState"
    if compress is not None:
        equal(t.cstate.reference, t2.cstate.reference)


@pytest.mark.parametrize("fused", [False, True])
def test_resume_past_end_still_reports_final(cfg, tmp_path, fused):
    path = str(tmp_path / "lm.ckpt")
    t = make(cfg)
    t.run(4, eval_every=4, ckpt_every=2, ckpt_path=path)
    t2 = make(cfg)
    assert t2.restore(path) == 4
    history = (t2.run_fused if fused else t2.run)(4, eval_every=4)
    assert len(history) == 1 and history[0]["round"] == 3
    assert np.isfinite(history[0]["loss"]) and "g2_token_spread" in history[0]
    equal(t.params, t2.params)


@pytest.mark.parametrize("fused", [False, True])
def test_resume_is_bit_identical(cfg, tmp_path, fused):
    path, grab = str(tmp_path / "lm.ckpt"), str(tmp_path / "lm_mid.ckpt")
    ref = make(cfg, compress=0.25)
    (ref.run_fused if fused else ref.run)(8, eval_every=4)
    t1 = make(cfg, compress=0.25)

    def snatch(rec):
        if rec["round"] == 6:  # the checkpoint of round 4 is on disk
            shutil.copy(path + ".npz", grab + ".npz")

    (t1.run_fused if fused else t1.run)(8, eval_every=2, on_round=snatch, ckpt_every=4,
                                        ckpt_path=path)
    t2 = make(cfg, compress=0.25)
    assert t2.restore(grab) == 5
    (t2.run_fused if fused else t2.run)(8, eval_every=4)
    equal(ref.params, t2.params)
    equal(ref.opt_state, t2.opt_state)
    equal(ref.cstate.reference, t2.cstate.reference)


def test_straggler_resume_raises(cfg, tmp_path):
    path = str(tmp_path / "lm.ckpt")
    t = make(cfg, faults="straggler:frac=0.5,delay=2")
    t.save(path, step=0)
    with pytest.raises(ValueError, match="straggler"):
        make(cfg, faults="straggler:frac=0.5,delay=2").restore(path)


def test_checkpoint_is_the_reference_s_format(cfg, tmp_path):
    """A port checkpoint restores in the reference (NamedTuple fields keyed
    as JAX keys them), with every leaf equal."""
    from repro.checkpoint import ckpt as ref_ckpt
    from repro.configs import base as ref_cfgbase
    from repro.train.trainer import LMCohortTrainer as RefTrainer

    path = str(tmp_path / "lm.ckpt")
    t = make(cfg, compress=0.25)
    t.run(2, eval_every=2)
    t.save(path, step=1)
    ref_cfg = dataclasses.replace(ref_cfgbase.get("llama32_1b").reduced(), **{
        k: getattr(cfg, k) for k in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                                     "head_dim", "d_ff", "vocab_size")})
    ref = RefTrainer("ring:n=4", ref_cfg, nodes=N, batch=2, seq=16, compress=0.25)
    like = {"params": ref.params, "opt": ref.opt_state, "cstate": ref.cstate}
    tree, step = ref_ckpt.restore(path, like)
    assert step == 1
    got = jax.tree.leaves(tree)
    want = tree_leaves(t.params) + tree_leaves(t.opt_state) + tree_leaves(t.cstate)
    assert len(got) == len(want)
    for g, w in zip(jax.tree.leaves(tree["params"]), tree_leaves(t.params)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    for g, w in zip(jax.tree.leaves(tree["opt"]), tree_leaves(t.opt_state)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
