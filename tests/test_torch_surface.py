"""The slice-A surface the port lacked, against the reference: the
trainer's ``gossip_first``, ``verbose``, ``init_fn`` and ``forward_fn``;
``GossipEngine.mix(backend=)`` and ``validate=``; ``decavg.gossip_error``;
and ``run_sweep`` over a process pool (with the sweep CLI's
``--processes``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decavg as ref_decavg
from repro.core import partition as ref_partition
from repro.data import loader as ref_loader
from repro.data.synthetic import make_mnist_like
from repro.models.mlp import init_mlp
from repro.train.trainer import DecentralizedTrainer as RefTrainer
from repro_torch.convert import params_from_numpy
from repro_torch.core import decavg, mesh, mixing
from repro_torch.data.loader import NodeLoader
from repro_torch.experiments import runner, sweep
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.store import ResultsStore
from repro_torch.models.mlp import init_mlp as port_init_mlp
from repro_torch.train.trainer import DecentralizedTrainer
from repro_torch.tree import tree_leaves

N, BATCH, DIM, HIDDEN = 10, 8, 32, (16,)
TOPOLOGY = "er:n=10,p=0.5"


@pytest.fixture(scope="module")
def data():
    ds = make_mnist_like(train_per_class=40, test_per_class=20, dim=DIM, seed=0)
    return ds, ref_partition.iid(ds.y_train, N, seed=1)


def _pair(data, **kw):
    ds, parts = data
    ref_ld = ref_loader.NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2)
    ref = RefTrainer(TOPOLOGY, ref_ld, lr=0.05, momentum=0.9, seed=0, in_dim=DIM,
                     init_fn=lambda k: init_mlp(k, in_dim=DIM, hidden=HIDDEN), **kw)
    key, sizes = jax.random.PRNGKey(2), jnp.asarray(ref_ld.sizes.astype(np.int32))
    loader = NodeLoader(
        ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2, device="cpu",
        index_fn=lambda r, steps: np.asarray(
            ref_loader.round_batch_indices(key, r, steps, BATCH, sizes)),
    )
    port = DecentralizedTrainer(
        TOPOLOGY, loader, lr=0.05, momentum=0.9, seed=0, in_dim=DIM, device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu"), **kw,
    )
    return ref, port


def _own(data, **kw):
    ds, parts = data
    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2, device="cpu")
    kw.setdefault("hidden", HIDDEN)
    return DecentralizedTrainer(TOPOLOGY, loader, lr=0.05, momentum=0.9, seed=0, in_dim=DIM,
                                device="cpu", **kw)


@pytest.mark.parametrize("mix_impl", ["dense", "sparse"])
@pytest.mark.parametrize("path", ["run", "run_fused"])
def test_gossip_first_matches_reference(data, mix_impl, path):
    ref, port = _pair(data, mix_impl=mix_impl)
    getattr(ref, path)(3, gossip_first=True)
    getattr(port, path)(3, gossip_first=True)
    for g, w in zip(tree_leaves(port.params), jax.tree.leaves(ref.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_gossip_first_loop_matches_fused(data):
    """The reference's tests/test_fused.py pin, in the port."""
    loop, fused = _own(data), _own(data)
    loop.run(3, gossip_first=True)
    fused.run_fused(3, gossip_first=True)
    for a, b in zip(tree_leaves(loop.params), tree_leaves(fused.params)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    plain = _own(data)
    plain.run(3)
    assert not torch.equal(tree_leaves(plain.params)[0], tree_leaves(loop.params)[0])


@pytest.mark.parametrize("path", ["run", "run_fused"])
def test_verbose_prints_the_reference_line(data, path, capsys):
    ds, _ = data
    hist = getattr(_own(data), path)(3, eval_every=2, x_test=ds.x_test, y_test=ds.y_test,
                                     verbose=True)
    lines = capsys.readouterr().out.strip().splitlines()
    accs = hist[-1].per_node_acc
    assert len(lines) == 2 and lines[-1] == (
        f"round    2  acc mean {accs.mean():.4f} std {accs.std():.4f} "
        f"min {accs.min():.4f} max {accs.max():.4f}")


def _node_forward(p, x):
    """One node's MLP forward pass (its params without the node axis)."""
    h = x
    for i, layer in enumerate(p["layers"]):
        h = h @ layer["w"] + layer["b"]
        if i < len(p["layers"]) - 1:
            h = torch.relu(h)
    return h


@pytest.mark.parametrize("path", ["run", "run_fused"])
def test_init_fn_and_forward_fn(data, path):
    """A per-node forward pass mapped over the nodes, and an init hook that
    draws one node's params from the generator, train as the defaults do."""
    ds, _ = data
    calls = []

    def init_fn(gen):
        calls.append(gen)
        return port_init_mlp(gen, in_dim=DIM, hidden=HIDDEN)

    base = _own(data)
    hooked = _own(data, init_fn=init_fn, forward_fn=_node_forward, hidden=None)
    assert len(calls) == 1 and isinstance(calls[0], torch.Generator)
    for a, b in zip(tree_leaves(base.params), tree_leaves(hooked.params)):
        assert torch.equal(a, b)
    ha = getattr(base, path)(3, eval_every=2, x_test=ds.x_test, y_test=ds.y_test)
    hb = getattr(hooked, path)(3, eval_every=2, x_test=ds.x_test, y_test=ds.y_test)
    for a, b in zip(tree_leaves(base.params), tree_leaves(hooked.params)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ha[-1].per_node_acc, hb[-1].per_node_acc, atol=1e-6)
    apart = _own(data, init_fn=init_fn, same_init=False, hidden=None)
    assert len(calls) == 1 + N
    w = apart.params["layers"][0]["w"]
    assert not torch.equal(w[0], w[1])


def test_gossip_error_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((N, 4, 3)).astype(np.float32),
            "b": rng.standard_normal((N, 5)).astype(np.float32) + 2.0}
    got = decavg.gossip_error({k: torch.as_tensor(v) for k, v in tree.items()})
    want = ref_decavg.gossip_error({k: jnp.asarray(v) for k, v in tree.items()})
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    same = {"a": torch.ones(N, 3)}
    assert float(decavg.gossip_error(same)) == 0.0


@pytest.mark.parametrize("base", ["dense", "sparse"])
@pytest.mark.parametrize("override", ["dense", "pallas", "sparse", "sparse_pallas"])
def test_mix_backend_override_matches_reference(base, override):
    """A per-call override mixes as the reference's does and leaves the
    engine's own backend (and its later calls) alone."""
    rng = np.random.default_rng(1)
    p = rng.standard_normal((N, 6)).astype(np.float32)
    ref = ref_decavg.GossipEngine(TOPOLOGY, backend=base, seed=0, interpret=True)
    eng = decavg.GossipEngine(TOPOLOGY, backend=base, seed=0, device="cpu")
    want = ref.mix(jnp.asarray(p), backend=override)
    got = eng.mix(torch.as_tensor(p), backend=override)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-5)
    assert eng.backend == base
    torch.testing.assert_close(eng.mix(torch.as_tensor(p), spec=override), got)
    torch.testing.assert_close(eng.mix(torch.as_tensor(p)),
                               decavg.GossipEngine(TOPOLOGY, backend=base, seed=0,
                                                   device="cpu").mix(torch.as_tensor(p)))


def test_mix_backend_override_is_checked():
    eng = decavg.GossipEngine(TOPOLOGY, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        eng.mix(torch.zeros(N, 2), backend="bogus")
    with pytest.raises(ValueError, match="needs a mesh"):
        eng.mix(torch.zeros(N, 2), backend="permute")
    wrong = mesh.Mesh([torch.device("cpu")] * (N + 1), ("data",))
    meshed = decavg.GossipEngine(TOPOLOGY, mesh=wrong, backend="dense", device="cpu")
    with pytest.raises(ValueError, match="num_nodes"):
        meshed.mix(torch.zeros(N, 2), backend="permute")
    assert eng.backend == "dense" and meshed.backend == "dense"


def test_validate_flag(monkeypatch):
    def boom(w, g):
        raise AssertionError("validate_mixing ran")

    monkeypatch.setattr(mixing, "validate_mixing", boom)
    eng = decavg.GossipEngine(TOPOLOGY, validate=False, device="cpu")
    eng.refresh(1)
    with pytest.raises(AssertionError, match="validate_mixing ran"):
        decavg.GossipEngine(TOPOLOGY, device="cpu")


TINY = dict(rounds=2, eval_every=1, batch_size=8, model={"hidden": [16]},
            data={"train_per_class": 20, "test_per_class": 10})


def test_run_sweep_over_two_processes(tmp_path):
    specs = [ExperimentSpec("ring:n=6", seed=s, **TINY) for s in (0, 1)]
    specs.append(ExperimentSpec("ring:n=6", faults="churn:p_leave=0.3", **TINY))
    path = str(tmp_path / "pool.jsonl")
    out = runner.run_sweep(specs, path, processes=2, device="cpu")
    assert out["failed"] == [] and out["ran"] == 3
    finals = ResultsStore(path).finals()
    assert set(finals) == {s.run_id for s in specs}
    assert all(f["final"]["device"] == "cpu" for f in finals.values())
    assert "alive_min" in finals[specs[-1].run_id]["final"]
    assert not (tmp_path / "pool.jsonl.shards").exists()
    again = runner.run_sweep(specs, path, processes=2, device="cpu")
    assert again["ran"] == 0 and again["skipped"] == 3
    # The same specs in one process give the same records.
    serial = str(tmp_path / "serial.jsonl")
    runner.run_sweep(specs, serial, device="cpu")
    for s in specs:
        a, b = ResultsStore(path).curves(s.run_id), ResultsStore(serial).curves(s.run_id)
        assert [r["mean_acc"] for r in a] == pytest.approx([r["mean_acc"] for r in b], abs=1e-6)


def test_sweep_cli_takes_processes(tmp_path, capsys):
    store = str(tmp_path / "cli.jsonl")
    assert sweep.main(["--preset", "churn_smoke", "--list", "--processes", "2"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 4
    with pytest.raises(SystemExit):
        sweep.main(["--processes", "two", "--store", store])
    assert "--processes" in sweep.__doc__
