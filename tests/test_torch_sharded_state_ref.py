"""The sharded state against the reference: the port's ``run_fused`` on
``sparse_sharded`` over 8 shards of the CPU, node state held as slabs end
to end, within 1e-5 of the reference trainer's ``sparse`` run_fused from the
reference's injected weights and batch indices: plain, faulted (churn, and
stragglers with delay 2) and CHOCO, static and ``@rewire``, both halo
schedules. The reference's own ``sparse_sharded`` runs disagree loop
against fused, so its ``sparse`` trainer is the yardstick.

CHOCO is held to the reference at ``k_frac = 1`` (every entry sent: the
compression, the mix of the references and the residual on each slab).
At 0.25 this data has exact ties in a node's delta magnitudes (after one
round, node 20 of the static run sends one of two entries of magnitude
0.005934), which ``torch.topk`` and ``jax.lax.top_k`` order differently, so
the port's unsharded ``sparse`` run leaves the reference's by 6e-3 there
too; CHOCO 0.25 on the sharded state is held to the port's own ``sparse``
bits (``tests/test_torch_sharded_state.py``).
"""

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
from repro_torch.core import mesh
from repro_torch.data.loader import NodeLoader
from repro_torch.train.trainer import DecentralizedTrainer
from repro_torch.tree import tree_leaves

N, BATCH, DIM, HIDDEN = 24, 8, 32, (16,)
CPU = torch.device("cpu")
TOPOLOGIES = {"static": "ws:n=24,k=4,beta=0.2", "rewire": "ba:n=24,m=2@rewire=2"}
MODES = {
    "plain": {},
    "churn": {"faults": "churn:p_leave=0.2,p_join=0.3;drop:p_edge=0.1"},
    "stragglers": {"faults": "churn:p_leave=0.2,p_join=0.3;straggler:frac=0.25,delay=2;"
                             "drop:p_edge=0.1"},
    "choco": {"compress": 1.0},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    ds = make_mnist_like(train_per_class=48, test_per_class=10, dim=DIM, seed=0)
    return ds, ref_partition.iid(ds.y_train, N, seed=1)


def _pair(data, topology, halo, **kw):
    """The reference's sparse trainer, and the port's sparse_sharded one on
    its weights and batch indices over 8 CPU shards."""
    ds, parts = data
    ref_ld = ref_loader.NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2)
    ref = RefTrainer(topology, ref_ld, lr=0.05, momentum=0.9, mix_impl="sparse", seed=0,
                     in_dim=DIM, init_fn=lambda k: init_mlp(k, in_dim=DIM, hidden=HIDDEN),
                     **kw)
    key, sizes = jax.random.PRNGKey(ref_ld.seed), jnp.asarray(ref_ld.sizes.astype(np.int32))

    def index_fn(r, steps):
        return np.asarray(ref_loader.round_batch_indices(key, r, steps, BATCH, sizes))

    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2,
                        device="cpu", index_fn=index_fn)
    port = DecentralizedTrainer(
        topology, loader, lr=0.05, momentum=0.9, mix_impl="sparse_sharded", seed=0,
        in_dim=DIM, device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu"), **kw)
    port.engine.mesh = mesh.Mesh([CPU] * 8, ("data",))
    port.engine.halo_schedule = halo
    return ref, port


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_sharded_state_matches_the_reference_sparse_trainer(data, topology, mode):
    ds, _ = data
    ref, port = _pair(data, TOPOLOGIES[topology], "ring" if topology == "static" else "allgather",
                      **MODES[mode])
    want = ref.run_fused(4, eval_every=2, x_test=ds.x_test, y_test=ds.y_test)
    got = port.run_fused(4, eval_every=2, x_test=ds.x_test, y_test=ds.y_test)
    pairs = [(port.params, ref.params), (port.momentum, ref.opt_state)]
    if port.cstate is not None:
        pairs.append((port.cstate.reference, ref.cstate.reference))
    for mine, theirs in pairs:
        for g, w in zip(tree_leaves(mine), jax.tree.leaves(theirs), strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert [m.round for m in got] == [m.round for m in want] == [0, 2, 3]
    for g, w in zip(got, want):
        assert np.max(np.abs(g.per_node_acc - w.per_node_acc)) <= 1.0 / len(ds.y_test) + 1e-6
        assert abs(g.mean_acc - w.mean_acc) <= 1e-5
        np.testing.assert_allclose(g.consensus, np.asarray(w.consensus), rtol=1e-5, atol=1e-6)
