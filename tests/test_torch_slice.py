"""Slice A end to end: the port's DecentralizedTrainer.run against the
reference's, from the same initial weights and the same batch indices, for
the dense and pallas backends; run ids equal across packages; the runner's
records keyed as the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import partition as ref_partition
from repro.data import loader as ref_loader
from repro.data.synthetic import make_mnist_like
from repro.experiments import presets as ref_presets
from repro.experiments import runner as ref_runner
from repro.experiments.spec import ExperimentSpec as RefSpec
from repro.experiments.store import ResultsStore as RefStore
from repro.models.mlp import init_mlp
from repro.train.trainer import DecentralizedTrainer as RefTrainer
from repro_torch.convert import params_from_numpy
from repro_torch.data.loader import NodeLoader
from repro_torch.experiments import presets, runner
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.store import ResultsStore
from repro_torch.tree import tree_leaves
from repro_torch.train.trainer import DecentralizedTrainer

N, BATCH, HIDDEN, DIM, ROUNDS = 8, 4, (32, 16), 64, 3
GROUPS = np.array([0] * 5 + [1] * 5)


@pytest.fixture(scope="module")
def data():
    ds = make_mnist_like(train_per_class=20, test_per_class=10, dim=DIM, seed=0)
    from repro.core import topology as ref_topology

    g = ref_topology.make("ba:n=8,m=2", seed=0)
    parts = ref_partition.hub_focused(ds.y_train, g, seed=1)
    return ds, parts


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("same_init", [True, False])
def test_run_matches_reference_run(data, backend, same_init):
    ds, parts = data
    ref_ld = ref_loader.NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2)
    ref = RefTrainer(
        "ba:m=2", ref_ld, lr=0.05, momentum=0.9, mix_impl=backend, seed=0,
        same_init=same_init, in_dim=DIM, class_groups=GROUPS,
        init_fn=lambda k: init_mlp(k, in_dim=DIM, hidden=HIDDEN, num_classes=10),
    )
    p0 = jax.tree.map(np.asarray, ref.params)
    key = jax.random.PRNGKey(2)
    sizes = jnp.asarray(ref_ld.sizes.astype(np.int32))

    def index_fn(r, steps):
        return np.asarray(ref_loader.round_batch_indices(key, r, steps, BATCH, sizes))

    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2,
                        device="cpu", index_fn=index_fn)
    port = DecentralizedTrainer(
        "ba:m=2", loader, lr=0.05, momentum=0.9, mix_impl=backend, seed=0,
        in_dim=DIM, class_groups=GROUPS, params=params_from_numpy(p0, "cpu"),
        device="cpu",
    )
    assert loader.steps_per_epoch() > 1
    want = ref.run(ROUNDS, eval_every=2, x_test=ds.x_test, y_test=ds.y_test)
    got = port.run(ROUNDS, eval_every=2, x_test=ds.x_test, y_test=ds.y_test)

    for g, w in zip(tree_leaves(port.params), jax.tree.leaves(ref.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert [m.round for m in got] == [m.round for m in want] == [0, 2]
    one_example = 1.0 / len(ds.y_test)
    for g, w in zip(got, want):
        assert np.max(np.abs(g.per_node_acc - w.per_node_acc)) <= one_example + 1e-6
        assert np.max(np.abs(g.group_acc - w.group_acc)) <= 2 * one_example + 1e-6
        np.testing.assert_allclose(g.consensus, w.consensus, rtol=1e-4, atol=1e-6)
    cm = port.confusion(ds.x_test, ds.y_test)
    assert cm.shape == (N, 10, 10)
    np.testing.assert_allclose(cm.sum(axis=-1), 1.0, atol=1e-6)


def test_same_init_starts_every_node_equal(data):
    ds, parts = data
    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, device="cpu")
    same = DecentralizedTrainer("ba:m=2", loader, in_dim=DIM, device="cpu")
    apart = DecentralizedTrainer("ba:m=2", loader, in_dim=DIM, same_init=False, device="cpu")
    w_same, w_apart = same.params["layers"][0]["w"], apart.params["layers"][0]["w"]
    assert w_same.shape == (N, DIM, 512)
    assert all((w_same[i] == w_same[0]).all() for i in range(N))
    assert not (w_apart[1] == w_apart[0]).all()


def test_compress_and_faults_are_not_ported(data):
    """(Named before slice E ported both options.) Each option now builds a
    trainer, and the two refuse each other, as in the reference."""
    ds, parts = data
    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, device="cpu")
    compressed = DecentralizedTrainer("ba:m=2", loader, compress=0.1, in_dim=DIM, device="cpu")
    assert compressed.compress == 0.1 and compressed.cstate is not None
    faulted = DecentralizedTrainer("ba:m=2", loader, faults="churn:p_leave=0.1", in_dim=DIM,
                                   device="cpu")
    assert faulted.faulted and faulted.engine.fault_trace.n == N
    with pytest.raises(ValueError, match="do not compose with compress"):
        DecentralizedTrainer("ba:m=2", loader, compress=0.1, faults="churn:p_leave=0.1",
                             in_dim=DIM, device="cpu")


@pytest.mark.parametrize("preset", ["smoke", "paper"])
def test_run_ids_equal_across_packages(preset):
    ref = ref_presets.get_preset(preset)
    port = presets.get_preset(preset)
    assert [s.run_id for s in port] == [s.run_id for s in ref]
    assert [s.to_json() for s in port] == [s.to_json() for s in ref]


TINY = dict(rounds=2, eval_every=1, batch_size=8,
            data={"train_per_class": 30, "test_per_class": 10})
NARROW = {"hidden": [32, 16]}  # keeps the reference's interpret-mode kernel quick


@pytest.mark.parametrize(
    "spec",
    [dict(topology="ba:n=8,m=2", partitioner="hub_focused", backend="dense"),
     dict(topology="sbm:n=8,blocks=2,p_in=0.8,p_out=0.1", partitioner="community",
          backend="pallas", model=NARROW),
     dict(topology="ring:n=6@regen=1", backend="dense", model=NARROW)],
    ids=["ba-hub", "sbm-community", "ring-regen"],
)
def test_records_keyed_as_the_reference(tmp_path, spec):
    ref_store, port_store = RefStore(str(tmp_path / "ref.jsonl")), ResultsStore(str(tmp_path / "t.jsonl"))
    ref_spec = RefSpec(**spec, **TINY)
    port_spec = ExperimentSpec(**spec, **TINY)
    ref_out = ref_runner.run_spec(ref_spec, ref_store)
    out = runner.run_spec(port_spec, port_store, device="cpu")
    assert out["status"] == ref_out["status"] == "completed"
    assert out["run_id"] == ref_out["run_id"]
    ref_rounds, rounds = ref_store.curves(ref_spec.run_id), port_store.curves(port_spec.run_id)
    assert [sorted(r) for r in rounds] == [sorted(r) for r in ref_rounds]
    assert [r["round"] for r in rounds] == [0, 1]
    final = port_store.finals()[port_spec.run_id]["final"]
    ref_final = ref_store.finals()[ref_spec.run_id]["final"]
    assert set(final) == set(ref_final) | {"framework", "device"}
    assert final["framework"] == "torch" and final["device"] == "cpu"
    # The path taken, as the reference records it: fused for dense, the
    # per-round loop for pallas.
    assert final["fused"] is ref_final["fused"] is (spec["backend"] == "dense")
    assert final["backend"] == spec["backend"]
    assert final["graph"] == ref_final["graph"]


def test_runner_rejects_what_is_not_ported(tmp_path):
    """Every backend of the reference runs through the runner now. A faulted
    spec completes, a sparse_sharded spec completes fused (its provenance
    recorded), and both also in a sweep over two processes. (The lm
    executor runs too: tests/test_torch_lm_runner.py.)"""
    store = ResultsStore(str(tmp_path / "r.jsonl"))
    faulted = ExperimentSpec("ring:n=6", faults="churn:p_leave=0.1", **TINY)
    out = runner.run_spec(faulted, store, device="cpu")
    assert out["status"] == "completed" and out["final"]["faults"] == "churn:p_leave=0.1"
    assert all("alive_count" in r for r in store.curves(faulted.run_id))
    sharded = ExperimentSpec("ring:n=4", backend="sparse_sharded", model=NARROW, **TINY)
    out = runner.run_spec(sharded, store, raise_on_error=False, device="cpu")
    assert out["status"] == "completed"
    assert out["final"]["backend"] == "sparse_sharded" and out["final"]["fused"] is True
    tiny = ExperimentSpec("ring:n=6", model=NARROW, **TINY)
    summary = runner.run_sweep([sharded, tiny], str(tmp_path / "s.jsonl"), processes=2,
                               device="cpu")
    assert summary["ran"] == 2 and summary["failed"] == []
    finals = ResultsStore(str(tmp_path / "s.jsonl")).finals()
    assert finals[sharded.run_id]["final"]["backend"] == "sparse_sharded"
