"""Each module of the port against its JAX counterpart, on the same numpy
inputs: the engine's mixing matrices and schedules, dense mixing, the MLP
forward pass, the loss, the SGD step, the metrics and the loader's rules.
Float32 tolerances are 1e-6 or tighter unless a comment says why not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decavg as ref_decavg
from repro.data import loader as ref_loader
from repro.models import mlp as ref_mlp
from repro.optim import sgd as ref_sgd
from repro.train import losses as ref_losses
from repro.train import metrics as ref_metrics
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import decavg, mesh
from repro_torch.data.loader import NodeLoader
from repro_torch.models import mlp
from repro_torch.optim import sgd
from repro_torch.train import losses, metrics
from repro_torch.tree import tree_leaves

TOPOLOGIES = [
    "er:n=12,p=0.4",
    "ba:n=12,m=2",
    "sbm:n=12,blocks=3,p_in=0.7,p_out=0.05",
    "er:n=10,p=0.5@regen=2",
]


def _params(n: int, dims=(16, 8, 4), seed=0) -> dict:
    rng = np.random.default_rng(seed)
    layers = tuple(
        {"w": rng.normal(size=(n, a, b)).astype(np.float32) * 0.3,
         "b": rng.normal(size=(n, b)).astype(np.float32) * 0.1}
        for a, b in zip(dims[:-1], dims[1:])
    )
    return {"layers": layers}


def _flat(tree) -> list[np.ndarray]:
    return [np.asarray(leaf) for leaf in jax.tree.leaves(tree)]


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("matrix", ["decavg", "mh"])
def test_engine_w_matches_reference(topology, matrix):
    sizes = np.random.default_rng(1).integers(5, 40, size=12 if "n=12" in topology else 10)
    ref = ref_decavg.GossipEngine(topology, data_sizes=sizes, matrix=matrix,
                                  backend="dense", seed=3)
    port = decavg.GossipEngine(topology, data_sizes=sizes, matrix=matrix,
                               backend="dense", seed=3, device="cpu")
    for r in range(5):  # crosses @regen=2 period boundaries
        np.testing.assert_array_equal(port.w_at(r).numpy(), np.asarray(ref.w_at(r)))
        np.testing.assert_array_equal(port.graph_at(r).adj, ref.graph_at(r).adj)


@pytest.mark.parametrize("every,gossip", [(0, [False] * 4), (1, [True] * 4),
                                          (3, [True, False, False, True])])
def test_gossip_cadence(every, gossip):
    ref = ref_decavg.GossipEngine("ring:n=6", backend="dense", gossip_every=every)
    port = decavg.GossipEngine("ring:n=6", backend="dense", gossip_every=every, device="cpu")
    got = [port.is_gossip_round(r) for r in range(4)]
    assert got == gossip == [ref.is_gossip_round(r) for r in range(4)]
    p = {"layers": [{"w": torch.ones(6, 2, 2)}]}
    assert (port.mix(p, round=1) is p) == (not gossip[1])


def test_backend_resolution():
    assert decavg.GossipEngine("ring:n=8", device="cpu").backend == "dense"
    assert decavg.GossipEngine("ring:n=8", sparse_threshold=8, device="cpu").backend == "sparse"
    for backend in ("sparse", "sparse_pallas"):
        assert decavg.GossipEngine("ring:n=8", backend=backend, device="cpu").backend == backend
    # The mesh backends exist: sparse_sharded builds its default mesh, the
    # other two need one, as in the reference.
    eng = decavg.GossipEngine("ring:n=8", backend="sparse_sharded", device="cpu")
    assert eng.backend == "sparse_sharded" and eng.mesh.shape == {"data": 1}
    eight = mesh.Mesh([torch.device("cpu")] * 8, ("data",))
    for backend in ("sharded", "permute"):
        with pytest.raises(ValueError, match="needs a mesh"):
            decavg.GossipEngine("ring:n=8", backend=backend, device="cpu")
        assert decavg.GossipEngine("ring:n=8", backend=backend, mesh=eight,
                                   device="cpu").backend == backend
    assert decavg.GossipEngine("ring:n=8", mesh=eight, device="cpu").backend == "sharded"
    with pytest.raises(ValueError, match="unknown backend"):
        decavg.GossipEngine("ring:n=8", backend="nope", device="cpu")
    caps = decavg.GossipEngine.capabilities()
    ref_caps = ref_decavg.GossipEngine.capabilities()
    assert set(caps) == set(ref_caps) == set(decavg.GossipEngine.BACKENDS)
    for b, info in caps.items():
        assert set(info) == set(ref_caps[b])
        assert info["fused"] is ref_caps[b]["fused"] and info["faults"] is ref_caps[b]["faults"]
    assert "CUDA" in caps["pallas"]["notes"] and "CUDA" in caps["sparse_pallas"]["notes"]
    assert "O(E" in caps["sparse_sharded"]["cost"] and "Mesh" in caps["permute"]["requires"]


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_mix_matches_reference_mix_dense(backend):
    ref = ref_decavg.GossipEngine("ba:n=12,m=2", backend="dense", seed=1)
    port = decavg.GossipEngine("ba:n=12,m=2", backend=backend, seed=1, device="cpu")
    params = _params(12)
    want = ref_decavg.mix_dense(ref.w, jax.tree.map(jnp.asarray, params))
    got = port.mix(params_from_numpy(params, "cpu"), round=0)
    for g, w in zip(tree_leaves(got), _flat(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


def test_mix_dense_bf16_accumulates_in_leaf_dtype():
    ref = ref_decavg.GossipEngine("ring:n=8", backend="dense")
    w = decavg.GossipEngine("ring:n=8", backend="dense", device="cpu").w
    p = np.random.default_rng(0).uniform(-1, 1, (8, 33)).astype(np.float32)
    got = decavg.mix_dense(w, {"x": torch.from_numpy(p).bfloat16()})["x"]
    want = ref_decavg.mix_dense(ref.w, {"x": jnp.asarray(p, jnp.bfloat16)})["x"]
    assert got.dtype == torch.bfloat16
    # bf16 accumulation in both, in different orders: a few bf16 ulps.
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("shared_x", [False, True])
def test_mlp_forward_matches_reference(shared_x):
    params = _params(5)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(7, 16) if shared_x else (5, 7, 16)).astype(np.float32)
    fwd = jax.vmap(ref_mlp.mlp_forward, in_axes=(0, None if shared_x else 0))
    want = np.asarray(fwd(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    got = mlp.mlp_forward(params_from_numpy(params, "cpu"), torch.from_numpy(x)).numpy()
    assert got.shape == (5, 7, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_init_mlp_layout_and_scale():
    gen = torch.Generator().manual_seed(0)
    p = mlp.init_mlp(gen, in_dim=784)
    ref = ref_mlp.init_mlp(jax.random.PRNGKey(0), in_dim=784)
    assert [tuple(layer["w"].shape) for layer in p["layers"]] == [
        tuple(layer["w"].shape) for layer in ref["layers"]
    ]
    for layer in p["layers"]:
        assert torch.all(layer["b"] == 0)
        fan_in = layer["w"].shape[0]
        assert abs(float(layer["w"].std()) - (2.0 / fan_in) ** 0.5) < 0.2 * (2.0 / fan_in) ** 0.5


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 6, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, size=(4, 6))
    want = jax.vmap(ref_losses.softmax_xent)(jnp.asarray(logits), jnp.asarray(labels))
    got = losses.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    flat = losses.softmax_xent(torch.from_numpy(logits[0]), torch.from_numpy(labels[0]))
    assert flat.shape == () and abs(float(flat) - float(want[0])) < 1e-6


def test_sgd_step_matches_reference():
    params, grads, mom = _params(4, seed=1), _params(4, seed=2), _params(4, seed=3)
    ref_state = ref_sgd.SGDState(jax.tree.map(jnp.asarray, mom))
    want_p, want_s = ref_sgd.update(
        jax.tree.map(jnp.asarray, grads), ref_state, jax.tree.map(jnp.asarray, params),
        lr=0.05, mu=0.9,
    )
    p, m = params_from_numpy(params, "cpu"), params_from_numpy(mom, "cpu")
    sgd.update_(tree_leaves(params_from_numpy(grads, "cpu")), tree_leaves(m),
                tree_leaves(p), lr=0.05, mu=0.9)
    for got, want in zip(tree_leaves(p) + tree_leaves(m),
                         _flat(want_p) + _flat(want_s.momentum)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    zero = sgd.init(p)
    assert all(z.dtype == torch.float32 and not z.any() for z in tree_leaves(zero))


def test_metrics_match_reference():
    rng = np.random.default_rng(4)
    n, b, c = 5, 40, 10
    logits = rng.normal(size=(n, b, c)).astype(np.float32)
    labels = rng.integers(0, c, size=b)
    groups = (np.arange(c) >= c // 2).astype(np.int32)
    lj, yj = jnp.asarray(logits), jnp.asarray(labels)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)

    acc = jax.vmap(ref_metrics.accuracy, in_axes=(0, None))(lj, yj)
    np.testing.assert_allclose(metrics.accuracy(lt, yt).numpy(), np.asarray(acc), atol=1e-7)
    gacc = jax.vmap(ref_metrics.group_accuracy, in_axes=(0, None, None, None))(
        lj, yj, jnp.asarray(groups), 2)
    got = metrics.group_accuracy(lt, yt, torch.from_numpy(groups).long(), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(gacc), atol=1e-7)
    cm = jax.vmap(ref_metrics.confusion_matrix, in_axes=(0, None, None))(lj, yj, c)
    got_cm = metrics.confusion_matrix(lt, yt, c)
    np.testing.assert_allclose(got_cm.numpy(), np.asarray(cm), atol=1e-7)
    blocks = np.array([0, 1, 0, 2, 1])
    want = ref_metrics.community_confusion(cm, jnp.asarray(blocks), 3)
    got = metrics.community_confusion(got_cm, torch.from_numpy(blocks), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    params = _params(n)
    want = ref_metrics.consensus_distance(jax.tree.map(jnp.asarray, params))
    got = metrics.consensus_distance(params_from_numpy(params, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert tuple(metrics.consensus_distance({}).shape) == (0,)


def test_convert_round_trip():
    params = _params(3)
    back = params_to_numpy(params_from_numpy(params, "cpu"))
    assert isinstance(back["layers"], list)
    for a, b in zip(_flat(params), [x for layer in back["layers"] for x in (layer["b"], layer["w"])]):
        np.testing.assert_array_equal(a, b)


def _parts(sizes):
    starts = np.cumsum([0] + list(sizes))
    return [np.arange(s, s + k) for s, k in zip(starts[:-1], sizes)]


def test_loader_rules_match_reference():
    sizes = [10, 40, 25, 7]
    x = np.random.default_rng(5).normal(size=(sum(sizes), 6)).astype(np.float32)
    y = np.arange(sum(sizes)) % 3
    for b in (4, 8, 32):
        ref = ref_loader.NodeLoader(x, y, _parts(sizes), batch_size=b)
        port = NodeLoader(x, y, _parts(sizes), batch_size=b, device="cpu")
        assert port.steps_per_epoch() == ref.steps_per_epoch()
    with pytest.raises(ValueError, match="node 1 has an empty dataset"):
        NodeLoader(x, y, _parts([3, 0, 2]), batch_size=2, device="cpu")


def test_loader_sampler_is_a_pure_function_of_seed_and_round():
    sizes = [10, 40, 25, 7]
    x = np.random.default_rng(5).normal(size=(sum(sizes), 6)).astype(np.float32)
    y = np.arange(sum(sizes)) % 3
    a = NodeLoader(x, y, _parts(sizes), batch_size=8, seed=3, device="cpu")
    b = NodeLoader(x, y, _parts(sizes), batch_size=8, seed=3, device="cpu")
    assert torch.equal(a.round_indices(2, 3), b.round_indices(2, 3))
    assert not torch.equal(a.round_indices(2, 3), a.round_indices(1, 3))
    idx = a.round_indices(7, 50)
    assert idx.shape == (50, 4, 8)
    assert torch.all(idx >= 0) and torch.all(idx < torch.tensor(sizes)[None, :, None])
    assert all(len(np.unique(idx[:, n].numpy())) == sizes[n] for n in range(4))


def test_loader_index_fn_gathers_the_reference_batches():
    sizes = [10, 40, 25, 7]
    x = np.random.default_rng(5).normal(size=(sum(sizes), 6)).astype(np.float32)
    y = np.arange(sum(sizes)) % 3
    ref = ref_loader.NodeLoader(x, y, _parts(sizes), batch_size=8, seed=3)
    key, sz = jax.random.PRNGKey(3), jnp.asarray(np.array(sizes, np.int32))

    def index_fn(r, steps):
        return np.asarray(ref_loader.round_batch_indices(key, r, steps, 8, sz))

    port = NodeLoader(x, y, _parts(sizes), batch_size=8, seed=3, device="cpu",
                      index_fn=index_fn)
    xs, ys = ref.sample_round(3, round=4)
    for s, (xb, yb) in enumerate(port.batches(4, 3)):
        np.testing.assert_array_equal(xb.numpy(), xs[s])
        np.testing.assert_array_equal(yb.numpy(), ys[s])
