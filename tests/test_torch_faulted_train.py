"""Slice E through the trainer: the port's faulted and CHOCO
``DecentralizedTrainer`` against the reference's, from the reference's
initial weights and batch indices (as tests/test_torch_slice.py injects
them); the port's loop against its fused path; dead nodes frozen to the bit.
The ``churn_smoke`` preset through both runners is in test_torch_churn.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as ref_partition
from repro.data import loader as ref_loader
from repro.data.synthetic import make_mnist_like
from repro.models.mlp import init_mlp
from repro.train.trainer import DecentralizedTrainer as RefTrainer
from repro_torch.convert import params_from_numpy
from repro_torch.data import loader as port_loader
from repro_torch.train.trainer import DecentralizedTrainer
from repro_torch.tree import tree_leaves

N, BATCH, DIM, HIDDEN = 16, 8, 32, (16,)
TOPOLOGY = "ba:n=16,m=2"
COMBINED = "churn:p_leave=0.15,p_join=0.5;straggler:frac=0.3,delay=3;drop:p_edge=0.2"
KILL = "churn:p_leave=1.0,p_join=0.0,frac=0.25,start=2@targeted=hubs"


@pytest.fixture(scope="module")
def data():
    ds = make_mnist_like(train_per_class=40, test_per_class=20, dim=DIM, seed=0)
    return ds, ref_partition.iid(ds.y_train, N, seed=1)


def _index_fn(ref_ld):
    key = jax.random.PRNGKey(ref_ld.seed)
    sizes = jnp.asarray(ref_ld.sizes.astype(np.int32))

    def index_fn(r, steps):
        return np.asarray(ref_loader.round_batch_indices(key, r, steps, BATCH, sizes))

    return index_fn


def _pair(data, topology=TOPOLOGY, **kw):
    """The reference's trainer, and the port's on its weights and indices."""
    ds, parts = data
    ref_ld = ref_loader.NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2)
    ref = RefTrainer(
        topology, ref_ld, lr=0.05, momentum=0.9, seed=0, in_dim=DIM,
        init_fn=lambda k: init_mlp(k, in_dim=DIM, hidden=HIDDEN), **kw,
    )
    loader = port_loader.NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2,
                                    device="cpu", index_fn=_index_fn(ref_ld))
    port = DecentralizedTrainer(
        topology, loader, lr=0.05, momentum=0.9, seed=0, in_dim=DIM,
        params=params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu"),
        device="cpu", **kw,
    )
    return ref, port


def _own(data, topology=TOPOLOGY, **kw):
    ds, parts = data
    loader = port_loader.NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2,
                                    device="cpu")
    return DecentralizedTrainer(topology, loader, lr=0.05, momentum=0.9, seed=0, in_dim=DIM,
                                hidden=HIDDEN, device="cpu", **kw)


def _close(port_tree, ref_tree, atol):
    for g, w in zip(tree_leaves(port_tree), jax.tree.leaves(ref_tree)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)


def _same(a, b, tol):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=tol, atol=tol)


@pytest.mark.parametrize("mix_impl", ["dense", "sparse"])
@pytest.mark.parametrize("path", ["run", "run_fused"])
@pytest.mark.parametrize("faults,gossip_every", [(COMBINED, 1), (COMBINED, 2), (KILL, 1)])
def test_faulted_matches_reference(data, mix_impl, path, faults, gossip_every):
    ds, _ = data
    ref, port = _pair(data, mix_impl=mix_impl, faults=faults, gossip_every=gossip_every)
    want = getattr(ref, path)(5, eval_every=2, x_test=ds.x_test, y_test=ds.y_test)
    got = getattr(port, path)(5, eval_every=2, x_test=ds.x_test, y_test=ds.y_test)
    _close(port.params, ref.params, 1e-5)
    _close(port.momentum, ref.opt_state, 1e-5)
    assert [m.round for m in got] == [m.round for m in want] == [0, 2, 4]
    for g, w in zip(got, want):
        assert np.max(np.abs(g.per_node_acc - w.per_node_acc)) <= 1.0 / len(ds.y_test) + 1e-6


@pytest.mark.parametrize("mix_impl", ["dense", "sparse"])
@pytest.mark.parametrize("k_frac", [0.25, 1.0])
def test_choco_matches_reference(data, mix_impl, k_frac):
    ds, _ = data
    ref, port = _pair(data, mix_impl=mix_impl, compress=k_frac)
    ref.run(4)
    port.run(4)
    _close(port.params, ref.params, 1e-5)
    _close(port.cstate.reference, ref.cstate.reference, 1e-5)


def test_choco_full_k_is_decavg(data):
    """k_frac=1 sends the whole delta: CHOCO is W @ params (the reference's
    tests/test_fused.py tolerance)."""
    base, comp = _own(data), _own(data, compress=1.0)
    base.run(4)
    comp.run(4)
    _same(base.params, comp.params, 1e-5)


@pytest.mark.parametrize("mix_impl,gossip_every", [
    ("dense", 1), ("dense", 2), ("sparse", 1), ("sparse", 2)])
def test_faulted_loop_matches_fused(data, mix_impl, gossip_every):
    kw = dict(mix_impl=mix_impl, faults=COMBINED, gossip_every=gossip_every)
    loop, fused = _own(data, **kw), _own(data, **kw)
    loop.run(6)
    fused.run_fused(6)
    _same(loop.params, fused.params, 1e-6)
    _same(loop.momentum, fused.momentum, 1e-6)


def test_faulted_loop_matches_fused_rewire(data):
    kw = dict(mix_impl="sparse", faults=COMBINED)
    loop, fused = _own(data, "ba:n=16,m=2@rewire=3", **kw), _own(data, "ba:n=16,m=2@rewire=3", **kw)
    loop.run(7)
    fused.run_fused(7)
    _same(loop.params, fused.params, 1e-6)


@pytest.mark.parametrize("mix_impl,gossip_every", [
    ("dense", 1), ("sparse", 2), ("sparse_pallas", 1), ("sparse_pallas", 3)])
def test_choco_loop_matches_fused(data, mix_impl, gossip_every):
    kw = dict(mix_impl=mix_impl, compress=0.25, gossip_every=gossip_every)
    loop, fused = _own(data, **kw), _own(data, **kw)
    loop.run(5)
    fused.run_fused(5)
    _same(loop.params, fused.params, 1e-6)
    _same(loop.cstate.reference, fused.cstate.reference, 1e-6)


@pytest.mark.parametrize("path", ["run", "run_fused"])
def test_dead_nodes_frozen_through_training(data, path):
    """A node killed at round 2 holds exactly its post-round-1 params."""
    pre, full = _own(data, faults=KILL), _own(data, faults=KILL)
    getattr(pre, path)(2)
    getattr(full, path)(5)
    dead = ~full.engine.fault_trace.alive(4)
    assert dead.any() and not dead.all()
    for a, b in zip(tree_leaves(pre.params) + tree_leaves(pre.momentum),
                    tree_leaves(full.params) + tree_leaves(full.momentum)):
        assert torch.equal(a[dead], b[dead])
        assert not torch.allclose(a[~dead], b[~dead])


def test_churn_only_runs_without_history(data):
    tr = _own(data, faults="churn:p_leave=0.3,p_join=0.5")
    assert not tr._has_hist
    tr.run_fused(4)
    assert all(torch.isfinite(p).all() for p in tree_leaves(tr.params))


def test_options_refuse_what_the_reference_refuses(data):
    with pytest.raises(ValueError, match="compose with compress"):
        _own(data, faults=COMBINED, compress=0.5)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="top-k fraction"):
            _own(data, compress=bad)
    with pytest.raises(ValueError, match="does not support faults"):
        _own(data, mix_impl="pallas", faults=COMBINED)
    with pytest.raises(ValueError, match="sparse_p_chunk"):
        _own(data, mix_impl="sparse", faults=COMBINED, sparse_p_chunk=8)
    for path in ("run", "run_fused"):
        with pytest.raises(ValueError, match="gossip_first"):
            getattr(_own(data, faults=COMBINED), path)(2, gossip_first=True)
