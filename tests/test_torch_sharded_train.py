"""The node-sharded backends through the trainers and the engine's surface.

The DecAvg trainer on ``sparse_sharded`` (1 and 8 shards on the CPU, both
halo schedules, static and ``@rewire``, plain and faulted) gives the same
bits loop and fused, and the same bits as the port's ``sparse`` backend; it
is held to the reference trainer's ``sparse`` run within 1e-5 from the
reference's injected weights and batch indices (the reference's own
``sparse_sharded`` loop-vs-fused runs disagree, so it is not the yardstick).
A mesh without the trainer's device is refused; given none, the trainers
take the engine's default. The LM cohort's loop runs on ``sparse_sharded``
too. The engine's surface
mirrors the reference's own checks (tests/test_sparse.py).
"""

import dataclasses

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
from repro_torch.configs import base as cfgbase
from repro_torch.convert import params_from_numpy
from repro_torch.core import decavg, mesh, mixing
from repro_torch.data.loader import NodeLoader
from repro_torch.train.trainer import DecentralizedTrainer, LMCohortTrainer
from repro_torch.tree import tree_leaves

N, BATCH, DIM, HIDDEN = 24, 8, 32, (16,)
CPU = torch.device("cpu")
TOPOLOGIES = {"static": "ws:n=24,k=4,beta=0.2", "rewire": "ba:n=24,m=2@rewire=2"}
FAULTS = {
    "churn": "churn:p_leave=0.2,p_join=0.3;drop:p_edge=0.1",
    "stragglers": "churn:p_leave=0.2,p_join=0.3;straggler:frac=0.25,delay=2;drop:p_edge=0.1",
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small operations: one intra-op thread is faster for them and
    keeps the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    ds = make_mnist_like(train_per_class=48, test_per_class=10, dim=DIM, seed=0)
    return ds, ref_partition.iid(ds.y_train, N, seed=1)


def _trainer(data, backend, topology, shards=None, halo="auto", **kw):
    ds, parts = data
    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2, device="cpu")
    tr = DecentralizedTrainer(topology, loader, lr=0.05, momentum=0.9, mix_impl=backend,
                              seed=0, in_dim=DIM, hidden=HIDDEN, device="cpu", **kw)
    if shards is not None:
        tr.engine.mesh = mesh.Mesh([CPU] * shards, ("data",))
        tr.engine.halo_schedule = halo
    return tr


def _state(tr) -> list[torch.Tensor]:
    return tree_leaves(tr.params) + tree_leaves(tr.momentum)


def _same(a: list[torch.Tensor], b: list[torch.Tensor]) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("faults", [None, "churn", "stragglers"])
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("gossip_every", [1, 2])
def test_loop_fused_and_sparse_agree_to_the_bit(data, faults, topology, gossip_every):
    """sparse's loop and fused runs, and sparse_sharded's on 1 shard (the
    default mesh) and on 8 under both halo schedules: one set of bits."""
    kw = dict(gossip_every=gossip_every, faults=FAULTS.get(faults))
    spec = TOPOLOGIES[topology]
    runs = {}
    for name, backend, shards, halo in (("sparse", "sparse", None, "auto"),
                                        ("S=1", "sparse_sharded", None, "auto"),
                                        ("S=8 ring", "sparse_sharded", 8, "ring"),
                                        ("S=8 allgather", "sparse_sharded", 8, "allgather")):
        for path in ("run", "run_fused"):
            tr = _trainer(data, backend, spec, shards, halo, **kw)
            getattr(tr, path)(5)
            runs[name, path] = _state(tr)
    want = runs["sparse", "run"]
    for key, got in runs.items():
        assert _same(got, want), key


def test_fused_program_stages_the_sharded_layout(data):
    tr = _trainer(data, "sparse_sharded", TOPOLOGIES["rewire"], 8, "ring",
                  faults=FAULTS["stragglers"])
    prog = tr.engine.program(5)
    assert prog.kind == "sparse_sharded" and prog.shards == 8 and prog.num_periods == 3
    assert len(prog.sh_ring_send) == 7 and prog.halo_schedule == "ring"
    assert prog.sh_ell_idx.shape[:3] == (3, 8, 3) and len(prog.sh_widths) == 8
    assert prog.f_keep.shape[:2] == (5, 8)
    for r in range(5):  # each round's keep mask is the loop's, padding kept
        tr.engine.refresh(r)
        want, got = tr.engine.sharded_keep(r), prog.f_keep[r].numpy()
        assert np.array_equal(got[:, :want.shape[1]], want) and got[:, want.shape[1]:].all()
    assert prog.faulted and prog.delay_max == 2 and prog.pad_ratio >= 1.0


def _ref_pair(data, topology, faults=None):
    """The reference's sparse trainer, and the port's sparse_sharded one on
    its weights and batch indices, over 8 shards on the ring."""
    ds, parts = data
    ref_ld = ref_loader.NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2)
    ref = RefTrainer(topology, ref_ld, lr=0.05, momentum=0.9, mix_impl="sparse", seed=0,
                     in_dim=DIM, faults=faults,
                     init_fn=lambda k: init_mlp(k, in_dim=DIM, hidden=HIDDEN))
    key, sizes = jax.random.PRNGKey(ref_ld.seed), jnp.asarray(ref_ld.sizes.astype(np.int32))

    def index_fn(r, steps):
        return np.asarray(ref_loader.round_batch_indices(key, r, steps, BATCH, sizes))

    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2,
                        device="cpu", index_fn=index_fn)
    port = DecentralizedTrainer(
        topology, loader, lr=0.05, momentum=0.9, mix_impl="sparse_sharded", seed=0,
        in_dim=DIM, faults=faults, device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu"))
    port.engine.mesh = mesh.Mesh([CPU] * 8, ("data",))
    port.engine.halo_schedule = "ring"
    return ref, port


@pytest.mark.parametrize("faults", [None, "stragglers"])
@pytest.mark.parametrize("path", ["run", "run_fused"])
def test_matches_the_reference_sparse_trainer(data, faults, path):
    ds, _ = data
    ref, port = _ref_pair(data, TOPOLOGIES["rewire"], FAULTS.get(faults))
    want = getattr(ref, path)(4, eval_every=2, x_test=ds.x_test, y_test=ds.y_test)
    got = getattr(port, path)(4, eval_every=2, x_test=ds.x_test, y_test=ds.y_test)
    for g, w in zip(tree_leaves(port.params), jax.tree.leaves(ref.params), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    for g, w in zip(tree_leaves(port.momentum), jax.tree.leaves(ref.opt_state), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert [m.round for m in got] == [m.round for m in want] == [0, 2, 3]
    for g, w in zip(got, want):
        assert np.max(np.abs(g.per_node_acc - w.per_node_acc)) <= 1.0 / len(ds.y_test) + 1e-6


def test_trainer_refuses_a_mesh_it_cannot_hold(data):
    """The trainer's device is the home of its params and metrics: a mesh
    that does not hold it is refused with a ValueError before any round
    runs, whether it spans two devices or repeats one."""
    tr = _trainer(data, "sparse_sharded", TOPOLOGIES["static"])
    before = _state(tr)
    tr.engine.mesh = mesh.Mesh([torch.device("cuda", 0), torch.device("cuda", 1)], ("data",))
    for path in ("run", "run_fused"):
        with pytest.raises(ValueError, match="mesh on cuda:0, cuda:1, trainer on cpu"):
            getattr(tr, path)(2)
    tr.engine.mesh = mesh.Mesh([torch.device("cuda", 0)] * 2, ("data",))
    with pytest.raises(ValueError, match="mesh on cuda:0"):
        tr.run(2)
    assert _same(_state(tr), [t.clone() for t in before])


def test_other_mesh_backends_run_the_loop(data):
    """sharded and permute run through the loop (not fused, as in the
    reference) and stay within 1e-5 of dense."""
    runs = {}
    for backend, shards in (("dense", None), ("sharded", 8), ("permute", N)):
        m = None if shards is None else mesh.Mesh([CPU] * shards, ("data",))
        tr = _trainer(data, backend, TOPOLOGIES["static"], mesh=m)
        assert tr.supports_fused is (backend == "dense")
        tr.run(3)
        runs[backend] = _state(tr)
    for backend in ("sharded", "permute"):
        for a, b in zip(runs[backend], runs["dense"], strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["decavg", "lm"])
def test_trainer_takes_the_engines_default_mesh(data, monkeypatch, kind):
    """Given no mesh, a trainer runs sparse_sharded over the engine's
    default mesh (one shard per card on CUDA, one on the CPU), whatever it
    spans: here 4 shards of the CPU, with sparse's bits."""
    four = mesh.Mesh([CPU] * 4, ("data",))
    monkeypatch.setattr(decavg.GossipEngine, "_default_node_mesh", lambda self: four)
    if kind == "decavg":
        got, want = (_trainer(data, b, TOPOLOGIES["rewire"]) for b in ("sparse_sharded", "sparse"))
        paths = ("run", "run_fused")
    else:
        got, want = _lm("sparse_sharded"), _lm("sparse")
        paths = ("run",)
    assert got.engine.mesh is four
    assert decavg.GossipEngine("ring:n=8", backend="sparse_sharded", device="cpu").mesh is four
    for path in paths:
        getattr(got, path)(3)
        getattr(want, path)(3)
        assert _same(tree_leaves(got.params), tree_leaves(want.params)), path


# -- the LM cohort's loop ---------------------------------------------------------


def _lm(backend, **kw):
    cfg = dataclasses.replace(cfgbase.get("llama32_1b").reduced(), num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
                              head_dim=32, d_ff=128, vocab_size=256)
    return LMCohortTrainer("ba:n=8,m=2", cfg, nodes=8, batch=2, seq=16, lr=1e-3,
                           backend=backend, compress=None, device="cpu", **kw)


@pytest.mark.parametrize("shards", [1, 4, 8])
def test_lm_loop_on_sparse_sharded_is_sparse(shards):
    """The LM loop keeps the cohort on its device and mixes leaf by leaf
    through engine.mix: sparse_sharded at 1, 4 and 8 shards gives the
    sparse backend's bits, faulted too; run_fused refuses it, as the
    reference's does."""
    for faults in (None, "churn:p_leave=0.3,p_join=0.3;drop:p_edge=0.2"):
        want = _lm("sparse", faults=faults)
        want.run(3)
        got = _lm("sparse_sharded", faults=faults)
        got.engine.mesh = mesh.Mesh([CPU] * shards, ("data",))
        got.run(3)
        assert _same(tree_leaves(got.params), tree_leaves(want.params))
    with pytest.raises(ValueError, match="run_fused supports"):
        _lm("sparse_sharded").run_fused(2)


# -- the engine's surface (the reference's tests/test_sparse.py checks) ------------


class FakeMesh:  # the capability checks read only mesh.shape
    shape = {"data": 8}


def test_capability_checks():
    for backend in ("sharded", "permute"):
        with pytest.raises(ValueError, match="needs a mesh"):
            decavg.GossipEngine("ring:n=8", backend=backend, device="cpu")
        with pytest.raises(ValueError, match="needs a mesh"):
            ref_decavg.GossipEngine("ring:n=8", backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        decavg.GossipEngine("ring:n=8", backend="warp", device="cpu")
    with pytest.raises(ValueError, match="halo_schedule"):
        decavg.GossipEngine("ring:n=8", backend="sparse_sharded", halo_schedule="tree",
                            device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        decavg.GossipEngine("ring:n=12", backend="sparse_sharded", mesh=FakeMesh(), device="cpu")
    caps = decavg.GossipEngine.capabilities()
    assert set(caps) == set(decavg.GossipEngine.BACKENDS) == set(ref_decavg.GossipEngine.BACKENDS)
    assert "O(E" in caps["sparse"]["cost"] and "O(E" in caps["sparse_sharded"]["cost"]


def test_auto_backend_with_a_mesh():
    m = mesh.Mesh([CPU] * 8, ("data",))
    for n, faults, want in ((16, None, "sharded"), (16, "drop:p_edge=0.1", "sparse_sharded"),
                            (512, None, "sparse_sharded")):
        kw = dict(faults=faults)
        assert decavg.GossipEngine(f"ring:n={n}", mesh=m, device="cpu", **kw).backend == want
        assert ref_decavg.GossipEngine(f"ring:n={n}", mesh=FakeMesh(), **kw).backend == want


def test_sparse_sharded_defaults_to_local_device_mesh():
    e = decavg.GossipEngine("ring:n=8", backend="sparse_sharded", device="cpu")
    assert e.mesh is not None and e.mesh.shape[e.node_axis] == 1
    params = {"a": torch.randn(8, 5)}
    torch.testing.assert_close(e.mix(params)["a"], decavg.mix_dense(e.w, params)["a"],
                               rtol=3e-5, atol=3e-5)


def test_sparse_sharded_override_does_not_leak_mesh():
    e = decavg.GossipEngine("ring:n=8", backend="dense", device="cpu")
    params = {"a": torch.randn(8, 5)}
    out = e.mix(params, backend="sparse_sharded")
    torch.testing.assert_close(out["a"], decavg.mix_dense(e.w, params)["a"],
                               rtol=3e-5, atol=3e-5)
    assert e.mesh is None
    with pytest.raises(ValueError, match="needs a mesh"):
        e.mix(params, backend="sharded")


def test_permute_time_varying_recolors_per_period(monkeypatch):
    calls = []
    orig = mixing.edge_coloring
    monkeypatch.setattr(mixing, "edge_coloring", lambda g: (calls.append(1), orig(g))[1])
    e = decavg.GossipEngine("ring:n=8@rewire=2", backend="permute", mesh=FakeMesh(), seed=3,
                            device="cpu")
    assert len(calls) == 1  # construction colors period 0
    assert not e.refresh(1) and len(calls) == 1
    assert e.refresh(2) and len(calls) == 2
    assert not e.refresh(3) and len(calls) == 2
    assert e.refresh(4) and len(calls) == 3
    decavg.GossipEngine("ring:n=8@regen=2", backend="permute", mesh=FakeMesh(), device="cpu")


def test_permute_still_requires_matching_mesh_axis():
    with pytest.raises(ValueError, match="num_nodes"):
        decavg.GossipEngine("ring:n=12", backend="permute", mesh=FakeMesh(), device="cpu")
