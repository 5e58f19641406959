"""The port's CUDA code on the card: each kernel against its plain version,
the mixing backends against each other (the node-sharded ones too, on meshes
that repeat the card), ``run_fused``'s captured CUDA graphs against the
per-round loop (faulted, CHOCO and sharded rounds too), and serving through
the flash-attention kernel against the plain attention path.

Every test here is marked ``cuda`` and skips without a card. The file imports
neither jax nor the reference package, so it also runs where only PyTorch is
installed, without the suite's conftest:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import gc

import numpy as np
import pytest
import torch

from repro_torch.core import decavg, mesh, sparse, topology
from repro_torch.data.loader import NodeLoader
from repro_torch.configs import base as cfgbase
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gossip_mix as gm
from repro_torch.kernels import sparse_gossip as sg
from repro_torch.models import transformer as TF
from repro_torch.serve import decode as SD
from repro_torch.serve.engine import Engine
from repro_torch.train import trainer as trainer_mod
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=3e-5, atol=3e-5)


def _w(n: int, seed: int) -> torch.Tensor:
    """Row-stochastic W with whole zero tiles (the lower-left quarter)."""
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32)
    w[n // 2:, : n // 2] = 0.0
    w[np.arange(n), np.arange(n)] += 1.0
    return torch.from_numpy(w / w.sum(axis=1, keepdims=True))


@pytest.mark.parametrize("n,d", [(100, 401408), (100, 10), (130, 513), (1, 1), (300, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_sparse", [True, False])
def test_kernel_matches_plain(cuda, n, d, dtype, block_sparse):
    w = _w(n, seed=n + d).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(d)
    p = (torch.rand(n, d, generator=gen, device=cuda) * 2 - 1).to(dtype)
    reset_launches()
    got = gm.gossip_mix(w, p, block_sparse=block_sparse)
    torch.cuda.synchronize()
    assert LAUNCHES["gossip_mix"] == 1
    assert got.dtype == dtype and got.shape == (n, d)
    torch.testing.assert_close(got.float(), gm.gossip_mix_ref(w, p).float(), **_tol(dtype))


def _w_mma_tiles(n: int, seed: int) -> torch.Tensor:
    """Row-stochastic W whose 16 x 8 tiles (the kernel's MMA tiles, which it
    skips when all zero) are dead in bands: the lower-left quarter, and rows
    16-31 outside the diagonal band, so a live row tile has dead k-steps."""
    w = _w(n, seed)
    if n > 32:
        band = w[16:32].clone()
        w[16:32] = 0.0
        w[16:32, 8:40] = band[:, 8:40]
        w[16:32] /= w[16:32].sum(dim=1, keepdim=True)
    return w


@pytest.mark.parametrize("n", [1, 100, 112, 130, 300, 511])
@pytest.mark.parametrize("d", [1, 10, 513, 401408])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_sparse", [True, False])
def test_kernel_matches_plain_at_edges(cuda, n, d, dtype, block_sparse):
    """Ragged N around the 16-row MMA tile and the 128-row W chunk, D down to
    1 and past 2^18 columns, with dead MMA tiles skipped or not."""
    w = _w_mma_tiles(n, seed=n).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n * 7 + d)
    p = (torch.rand(n, d, generator=gen, device=cuda) * 2 - 1).to(dtype)
    reset_launches()
    got = gm.gossip_mix(w, p, block_sparse=block_sparse)
    torch.cuda.synchronize()
    assert LAUNCHES["gossip_mix"] == 1
    assert got.dtype == dtype and got.shape == (n, d)
    torch.testing.assert_close(got.float(), gm.gossip_mix_ref(w, p).float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_skipping_dead_tiles_changes_no_bit(cuda, dtype):
    w = _w_mma_tiles(100, seed=3).to(cuda)
    p = (torch.rand(100, 4096, generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda) * 2 - 1).to(dtype)
    assert torch.equal(gm.gossip_mix(w, p, block_sparse=True),
                       gm.gossip_mix(w, p, block_sparse=False))


def test_kernel_reads_a_non_contiguous_leaf_through_reshape(cuda):
    w = _w(16, seed=0).to(cuda)
    leaf = torch.rand(16, 9, 7, device=cuda).transpose(1, 2)  # not contiguous
    got = decavg.mix_pallas(w, {"x": leaf})["x"]
    torch.testing.assert_close(got, decavg.mix_dense(w, {"x": leaf})["x"], rtol=3e-5, atol=3e-5)


def test_engine_backends_agree_on_the_card(cuda):
    dense = decavg.GossipEngine("ba:n=100,m=2", backend="dense", device=cuda)
    kernel = decavg.GossipEngine("ba:n=100,m=2", backend="pallas", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    params = {"layers": [{"w": torch.randn(100, 784, 512, generator=gen, device=cuda),
                          "b": torch.randn(100, 512, generator=gen, device=cuda)}]}
    reset_launches()
    got = kernel.mix(params, round=0)
    assert LAUNCHES["gossip_mix"] == 2
    for a, b in zip(tree_leaves(got), tree_leaves(dense.mix(params, round=0))):
        torch.testing.assert_close(a, b, rtol=3e-5, atol=3e-5)


# -- the sparse kernels ----------------------------------------------------------

SPARSE_CASES = [  # (topology, D): the large_n layouts at their leaf widths, ragged N and D
    ("ws:n=1024,k=8,beta=0.1", 50176),
    ("torus:rows=32,cols=32", 64),
    ("caveman:cliques=128,size=8", 640),
    ("ring:n=1001", 1),
    ("ring:n=1001", 513),
    ("star:n=10", 10),
]


def _layouts(spec: str, dev):
    csr = sparse.csr_from_graph(topology.make(spec, seed=0))
    idx, val = sparse.ell_from_csr(csr)
    bell = sparse.block_ell_from_csr(csr)
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return {
        "sparse_gossip": (sg.gossip_mix_sparse, sg.sparse_gossip_ref, as_t(idx), as_t(val)),
        "sparse_gossip_blocked": (sg.gossip_mix_sparse_blocked, sg.sparse_gossip_blocked_ref,
                                  as_t(bell.idx), as_t(bell.val)),
    }, csr.shape[0]


@pytest.mark.parametrize("spec,d", SPARSE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["sparse_gossip", "sparse_gossip_blocked"])
def test_sparse_kernel_matches_plain(cuda, spec, d, dtype, kernel):
    layouts, n = _layouts(spec, cuda)
    fn, ref, idx, val = layouts[kernel]
    gen = torch.Generator(device=cuda).manual_seed(d)
    p = (torch.rand(n, d, generator=gen, device=cuda) * 2 - 1).to(dtype)
    reset_launches()
    got = fn(idx, val, p)
    torch.cuda.synchronize()
    assert LAUNCHES[kernel] == 1 and sum(LAUNCHES.values()) == 1
    assert got.dtype == dtype and got.shape == (n, d)
    torch.testing.assert_close(got.float(), ref(idx, val, p).float(), **_tol(dtype))


def test_blocked_kernel_skips_all_zero_tiles_exactly(cuda):
    """A period stacked beside a denser one carries extra all-zero tiles (and
    block 0 as their source): the result is bit-identical to its own layout."""
    csrs = [sparse.csr_from_graph(topology.make(s, seed=0))
            for s in ("ring:n=203", "er:n=203,p=0.2")]
    idx_st, val_st = sparse.stack_block_ell(csrs)
    own = sparse.block_ell_from_csr(csrs[0])
    assert idx_st.shape[2] > own.idx.shape[1]
    p = torch.rand(203, 777, device=cuda)
    got = sg.gossip_mix_sparse_blocked(torch.as_tensor(idx_st[0], device=cuda),
                                       torch.as_tensor(val_st[0], device=cuda), p)
    want = sg.gossip_mix_sparse_blocked(torch.as_tensor(own.idx, device=cuda),
                                        torch.as_tensor(own.val, device=cuda), p)
    assert torch.equal(got, want)


# (topology, D) at the kernels' edges: N not a multiple of the 32-row window
# (the last window holds rows past N); windows whose distinct sources lap the
# ring many times (er, ws rewired at beta=1) or whose entries take several
# plans (er p=0.1; ring:n=9000 spans more sources than one plan's bitmap); one
# source row in every window (star, whose hub row has 1023 slots); and widths
# that take the path without bulk copies (D = 1, 10, 513).
SPARSE_EDGE_CASES = [
    ("ring:n=7", 64),
    ("ws:n=1000,k=6,beta=0.2", 640),
    ("er:n=1024,p=0.02", 256),
    ("ws:n=1024,k=8,beta=1.0", 300),
    ("er:n=1024,p=0.1", 64),
    ("star:n=1024", 32),
    ("ring:n=9000", 16),
    ("ws:n=1024,k=8,beta=0.1", 1),
    ("ws:n=1024,k=8,beta=0.1", 10),
    ("ws:n=1024,k=8,beta=0.1", 513),
]


@pytest.mark.parametrize("spec,d", SPARSE_EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["sparse_gossip", "sparse_gossip_blocked"])
def test_sparse_kernel_matches_plain_at_edges(cuda, spec, d, dtype, kernel):
    layouts, n = _layouts(spec, cuda)
    fn, ref, idx, val = layouts[kernel]
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    p = (torch.rand(n, d, generator=gen, device=cuda) * 2 - 1).to(dtype)
    reset_launches()
    got = fn(idx, val, p)
    torch.cuda.synchronize()
    assert LAUNCHES[kernel] == 1 and sum(LAUNCHES.values()) == 1
    assert got.dtype == dtype and got.shape == (n, d)
    torch.testing.assert_close(got.float(), ref(idx, val, p).float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["sparse_gossip", "sparse_gossip_blocked"])
def test_sparse_kernel_reads_an_unaligned_slice(cuda, dtype, kernel):
    """P and C one element off a 16-byte boundary: the path without bulk copies."""
    layouts, n = _layouts("ws:n=1024,k=8,beta=0.1", cuda)
    fn, ref, idx, val = layouts[kernel]
    flat = torch.rand(n * 640 + 1, generator=torch.Generator(device=cuda).manual_seed(5),
                      device=cuda).to(dtype)
    p = flat[1:].view(n, 640)
    assert p.data_ptr() % 16 != 0 and p.is_contiguous()
    torch.testing.assert_close(fn(idx, val, p).float(), ref(idx, val, p).float(), **_tol(dtype))


@pytest.mark.parametrize("kernel", ["sparse_gossip", "sparse_gossip_blocked"])
def test_sparse_kernel_takes_unaligned_weights(cuda, kernel):
    """Weights one float off a 16-byte boundary: the wrapper hands the kernel
    an aligned copy, and the result is the same."""
    layouts, n = _layouts("ws:n=1024,k=8,beta=0.1", cuda)
    fn, ref, idx, val = layouts[kernel]
    flat = torch.zeros(val.numel() + 1, device=cuda)
    flat[1:] = val.flatten()
    shifted = flat[1:].view(val.shape)
    assert shifted.data_ptr() % 16 != 0
    p = torch.rand(n, 640, generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    assert torch.equal(fn(idx, shifted, p), fn(idx, val, p))


@pytest.mark.parametrize("d", [10, 50176])
@pytest.mark.parametrize("kernel", ["sparse_gossip", "sparse_gossip_blocked"])
def test_sparse_kernel_is_deterministic_and_replays_in_a_graph(cuda, d, kernel):
    """Two launches give the same bits, and so does a launch captured in a
    CUDA graph and replayed (the kernel's resources are set before capture)."""
    layouts, n = _layouts("ws:n=1024,k=8,beta=0.1", cuda)
    fn, _, idx, val = layouts[kernel]
    p = torch.rand(n, d, generator=torch.Generator(device=cuda).manual_seed(d), device=cuda)
    first = fn(idx, val, p)
    assert torch.equal(first, fn(idx, val, p))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            captured = fn(idx, val, p)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_kernel_matches_plain_on_a_period_stack(cuda, dtype):
    """Each period of a stack (unequal tile counts, extra all-zero tiles)."""
    sched = topology.make_schedule("ws:n=1024,k=8,beta=0.3@rewire=1", seed=0)
    csrs = [sparse.csr_from_graph(sched.graph_at(r)) for r in range(3)]
    idx_st, val_st = (torch.as_tensor(a, device=cuda) for a in sparse.stack_block_ell(csrs))
    p = (torch.rand(1024, 640, generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda) * 2 - 1).to(dtype)
    for t in range(3):
        got = sg.gossip_mix_sparse_blocked(idx_st[t], val_st[t], p)
        torch.testing.assert_close(got.float(),
                                   sg.sparse_gossip_blocked_ref(idx_st[t], val_st[t], p).float(),
                                   **_tol(dtype))


def test_engine_resolves_large_n_to_sparse_on_the_card(cuda):
    eng = decavg.GossipEngine("ws:n=1024,k=8,beta=0.1")
    assert eng.backend == "sparse" and eng.device.type == "cuda"


def test_sparse_backends_agree_on_the_card(cuda):
    params = {"w": torch.randn(1024, 784, 64, device=cuda), "b": torch.randn(1024, 64, device=cuda)}
    dense = decavg.GossipEngine("ws:n=1024,k=8,beta=0.1", backend="dense")
    want = dense.mix(params, round=0)
    for backend, kernel in (("sparse", None), ("sparse_pallas", "sparse_gossip_blocked")):
        eng = decavg.GossipEngine("ws:n=1024,k=8,beta=0.1", backend=backend)
        reset_launches()
        got = eng.mix(params, round=0)
        torch.cuda.synchronize()
        if kernel is not None:
            assert LAUNCHES[kernel] == 2
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=3e-5, atol=3e-5)


# -- run_fused on the card --------------------------------------------------------


def _trainer(dev, backend, topology_spec="ws:n=64,k=4,beta=0.1", **kw):
    rng = np.random.default_rng(0)
    x = rng.random((64 * 12, 32), dtype=np.float32)
    y = rng.integers(0, 10, size=64 * 12)
    parts = [np.arange(12 * i, 12 * i + 12) for i in range(64)]
    loader = NodeLoader(x, y, parts, batch_size=4, seed=1, device=dev)
    return trainer_mod.DecentralizedTrainer(
        topology_spec, loader, lr=0.05, momentum=0.9, mix_impl=backend, seed=0,
        in_dim=32, hidden=(16,), device=dev, **kw,
    ), x[:50], y[:50]


@pytest.mark.parametrize("topology_spec", ["ws:n=64,k=4,beta=0.1", "ws:n=64,k=4,beta=0.1@rewire=2"])
def test_sparse_fused_is_bit_identical_to_the_loop(cuda, topology_spec):
    loop, x, y = _trainer(cuda, "sparse", topology_spec)
    fused, _, _ = _trainer(cuda, "sparse", topology_spec)
    ha = loop.run(5, eval_every=2, x_test=x, y_test=y)
    hb = fused.run_fused(5, eval_every=2, x_test=x, y_test=y)
    for a, b in zip(tree_leaves(loop.params) + tree_leaves(loop.momentum),
                    tree_leaves(fused.params) + tree_leaves(fused.momentum)):
        assert torch.equal(a, b)
    assert [m.round for m in ha] == [m.round for m in hb] == [0, 2, 4]


@pytest.mark.parametrize("gossip_every", [1, 3])
def test_fused_replays_count_kernel_launches(cuda, gossip_every):
    tr, _, _ = _trainer(cuda, "sparse_pallas", gossip_every=gossip_every)
    loop, _, _ = _trainer(cuda, "sparse_pallas", gossip_every=gossip_every)
    reset_launches()
    tr.run_fused(7)
    torch.cuda.synchronize()
    gossip_rounds = sum(tr.engine.is_gossip_round(r) for r in range(7))
    assert LAUNCHES["sparse_gossip_blocked"] == 4 * gossip_rounds  # 4 leaves a round
    loop.run(7)
    for a, b in zip(tree_leaves(loop.params), tree_leaves(tr.params)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_an_earlier_runs_graphs_are_released(cuda, monkeypatch):
    """A CUDA graph destroyed during another capture breaks that capture.
    run_fused releases its graphs when it returns, so a garbage collection
    inside the next run's capture finds none of them."""
    tr, _, _ = _trainer(cuda, "dense")
    tr.run_fused(2)
    batch_at = tr.loader.batch_at

    def collecting(idx):
        gc.collect()  # runs inside the next capture, too
        return batch_at(idx)

    monkeypatch.setattr(tr.loader, "batch_at", collecting)
    tr.run_fused(2)
    assert all(torch.isfinite(p).all() for p in tree_leaves(tr.params))


def test_failed_capture_raises_instead_of_running_eagerly(cuda, monkeypatch):
    """A host sync inside the round cannot be captured: run_fused raises."""
    tr, _, _ = _trainer(cuda, "dense")
    xent = trainer_mod.softmax_xent

    def syncing_xent(logits, labels):
        out = xent(logits, labels)
        float(out.sum().item())  # a device-to-host sync
        return out

    monkeypatch.setattr(trainer_mod, "softmax_xent", syncing_xent)
    before = [p.clone() for p in tree_leaves(tr.params)]
    with pytest.raises(RuntimeError):
        tr.run_fused(3)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tr.params)))


# -- the node-sharded backends on the card -----------------------------------------


def _mlp_tree(n: int, dev, seed: int = 0) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"layers": [{"b": torch.randn(n, b, generator=gen, device=dev),
                        "w": torch.randn(n, a, b, generator=gen, device=dev)}
                       for a, b in ((64, 32), (32, 10))]}


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("halo", ["allgather", "ring"])
@pytest.mark.parametrize("topology_spec", ["ba:n=512,m=2", "ws:n=512,k=8,beta=0.1@rewire=2"])
def test_sparse_sharded_is_sparse_to_the_bit(cuda, shards, halo, topology_spec):
    """Every shard's rows summed in the sparse backend's slot order: the same
    bits as ``sparse`` on the card, for one shard and for eight on one card,
    over both periods of a rewired schedule."""
    m = mesh.Mesh([torch.device("cuda", 0)] * shards, ("data",))
    ref = decavg.GossipEngine(topology_spec, backend="sparse", seed=1, device=cuda)
    eng = decavg.GossipEngine(topology_spec, backend="sparse_sharded", mesh=m,
                              halo_schedule=halo, seed=1, device=cuda)
    params = _mlp_tree(512, cuda)
    for r in (0, 2):
        got, want = eng.mix(params, round=r), ref.mix(params, round=r)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    reset_launches()
    eng.mix(params)
    assert not any(LAUNCHES.values())  # plain PyTorch: no hand-written kernel


@pytest.mark.parametrize("faults", [None, "churn:p_leave=1.0,p_join=0.0,frac=0.25,start=2"
                                          "@targeted=hubs;straggler:frac=0.2,delay=2;drop:p_edge=0.1"])
def test_fused_sharded_rounds_replay_as_cuda_graphs(cuda, monkeypatch, faults):
    """run_fused captures the 8-shard ring mix once per period slot as a CUDA
    graph and replays it: loop, fused and the sparse backend's fused run
    give the same bits (faulted too)."""
    graphs = []
    orig = trainer_mod.Staged

    def staged(*a, **k):
        graphs.append(orig(*a, **k))
        return graphs[-1]

    monkeypatch.setattr(trainer_mod, "Staged", staged)
    runs = {}
    for name, backend, path in (("loop", "sparse_sharded", "run"),
                                ("fused", "sparse_sharded", "run_fused"),
                                ("sparse", "sparse", "run_fused")):
        tr, _, _ = _trainer(cuda, backend, "ws:n=64,k=4,beta=0.1@rewire=2", faults=faults)
        if backend == "sparse_sharded":
            tr.engine.mesh = mesh.Mesh([torch.device("cuda", 0)] * 8, ("data",))
            tr.engine.halo_schedule = "ring"
        graphs.clear()
        getattr(tr, path)(5)
        if path == "run_fused":  # the local steps and the 3 period slots' mixes
            assert len(graphs) == 4 and all(g.graph is not None for g in graphs)
        runs[name] = tree_leaves(tr.params) + tree_leaves(tr.momentum)
    for a, b, c in zip(runs["loop"], runs["fused"], runs["sparse"]):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_trainer_refuses_a_mesh_over_two_cards(cuda):
    """The trainers keep every node on one card: a mesh over two devices is
    refused before any round runs (no second card is needed to see it)."""
    tr, _, _ = _trainer(cuda, "sparse_sharded")
    tr.engine.mesh = mesh.Mesh([torch.device("cuda", 0), torch.device("cuda", 1)], ("data",))
    for path in ("run", "run_fused"):
        with pytest.raises(NotImplementedError, match="several devices"):
            getattr(tr, path)(2)


def test_trainer_default_mesh_is_one_shard_on_its_card(cuda):
    """Given no mesh, a sparse_sharded trainer runs one shard on its own card,
    whatever the engine's default (a shard per card) would span."""
    tr, _, _ = _trainer(cuda, "sparse_sharded")
    assert tr.engine.mesh.shape == {"data": 1}
    assert all(mesh.same_device(d, cuda) for d in tr.engine.mesh.device_set)
    tr.run_fused(2)


# -- slice E on the card: faults and CHOCO through the captured graphs -----------

# Hubs die at round 2, stragglers publish 2-round-old params, edges drop: a
# mask or a ring slot baked into a captured graph would replay round 0's
# (everyone alive, slot 0) on every later round.
FAULTS_FROM_2 = ("churn:p_leave=1.0,p_join=0.0,frac=0.25,start=2@targeted=hubs;"
                 "straggler:frac=0.2,delay=2;drop:p_edge=0.1")


@pytest.mark.parametrize("backend", ["dense", "sparse"])
@pytest.mark.parametrize("gossip_every", [1, 2])
def test_faulted_fused_matches_the_loop(cuda, backend, gossip_every):
    kw = dict(faults=FAULTS_FROM_2, gossip_every=gossip_every)
    loop, x, y = _trainer(cuda, backend, **kw)
    fused, _, _ = _trainer(cuda, backend, **kw)
    loop.run(6, eval_every=3, x_test=x, y_test=y)
    fused.run_fused(6, eval_every=3, x_test=x, y_test=y)
    for a, b in zip(tree_leaves(loop.params) + tree_leaves(loop.momentum),
                    tree_leaves(fused.params) + tree_leaves(fused.momentum)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    pre, _, _ = _trainer(cuda, backend, **kw)
    pre.run_fused(2)
    dead = torch.as_tensor(~fused.engine.fault_trace.alive(5), device=cuda)
    assert 0 < int(dead.sum()) < 64
    for a, b in zip(tree_leaves(pre.params), tree_leaves(fused.params)):
        assert torch.equal(a[dead], b[dead])  # frozen to the bit from their death


@pytest.mark.parametrize("gossip_every", [1, 3])
def test_choco_fused_matches_the_loop_on_sparse_pallas(cuda, gossip_every):
    loop, _, _ = _trainer(cuda, "sparse_pallas", gossip_every=gossip_every, compress=0.25)
    fused, _, _ = _trainer(cuda, "sparse_pallas", gossip_every=gossip_every, compress=0.25)
    reset_launches()
    fused.run_fused(7)
    torch.cuda.synchronize()
    gossip_rounds = sum(fused.engine.is_gossip_round(r) for r in range(7))
    assert LAUNCHES["sparse_gossip_blocked"] == 4 * gossip_rounds  # the references' 4 leaves
    loop.run(7)
    for a, b in zip(tree_leaves(loop.params) + tree_leaves(loop.cstate.reference),
                    tree_leaves(fused.params) + tree_leaves(fused.cstate.reference)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_choco_full_k_on_the_gossip_mix_kernel_is_decavg(cuda):
    base, _, _ = _trainer(cuda, "pallas")
    comp, _, _ = _trainer(cuda, "pallas", compress=1.0)
    base.run(4)
    reset_launches()
    comp.run(4)
    torch.cuda.synchronize()
    assert LAUNCHES["gossip_mix"] == 4 * 4  # 4 leaves a gossip round
    for a, b in zip(tree_leaves(base.params), tree_leaves(comp.params)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# -- flash attention and serving (slice C) -----------------------------------


@pytest.mark.parametrize(
    "b,s,h,hkv,hd,window",
    [(1, 64, 4, 2, 32, None), (2, 100, 8, 2, 32, None), (1, 128, 4, 4, 64, 48),
     (1, 96, 8, 1, 32, 16), (1, 300, 32, 8, 64, None), (1, 130, 16, 16, 80, 40),
     (2, 65, 16, 2, 128, None), (1, 2, 32, 8, 64, None)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, b, s, h, hkv, hd, window, dtype, causal):
    gen = torch.Generator(device=cuda).manual_seed(s * 7 + h)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=cuda).to(dtype)
               for n in (h, hkv, hkv))
    reset_launches()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 3e-2 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_inputs(cuda, dtype):
    """q, k, v as views into one fused projection, as strides and no copy,
    and a T other than S (keys past the queries' positions masked)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 96, 8 + 2 * 2, 64, generator=gen, device=cuda).to(dtype)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    tol = 3e-2 if dtype == torch.bfloat16 else 3e-5
    for kv_len in (96, 70):
        got = fa.flash_attention(q, k[:, :kv_len], v[:, :kv_len])
        want = fa.flash_attention_ref(q, k[:, :kv_len], v[:, :kv_len])
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "s,t,h,hkv,hd,window",
    [(1, 1, 8, 8, 64, None), (63, 63, 12, 4, 64, None), (64, 64, 8, 1, 32, None),
     (65, 65, 24, 3, 64, None), (1001, 1001, 16, 2, 128, None), (1001, 1001, 32, 4, 80, 200),
     (65, 130, 12, 4, 64, None), (130, 65, 8, 2, 32, None), (64, 64, 16, 8, 64, 16),
     (200, 200, 40, 5, 80, None), (100, 100, 18, 3, 128, None), (96, 96, 12, 2, 32, 33),
     (1, 64, 32, 8, 64, None)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_edges(cuda, s, t, h, hkv, hd, window, dtype, causal):
    """The tiles the bf16 design masks (the diagonal, the window edge, ragged
    S and T) at S = 1, 63, 64, 65 and 1001, S != T, GQA groups 1 to 8,
    including groups that leave warpgroups of a block without a head (3, 5
    and 6), at every hd."""
    gen = torch.Generator(device=cuda).manual_seed(s * 31 + t + h)
    q = torch.randn(2, s, h, hd, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(2, t, hkv, hd, generator=gen, device=cuda).to(dtype) for _ in range(2))
    reset_launches()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 3e-2 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    x = torch.zeros(1, 8, 4, 66, device=cuda)[..., 1:65]  # rows off the 4-value grid
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention(x, x[:, :, :2], x[:, :, :2])
    # bf16 needs 16 bytes too: 8 values, not 4.
    y = torch.zeros(1, 8, 4, 72, device=cuda, dtype=torch.bfloat16)[..., 4:68]
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention(y, y[:, :, :2], y[:, :, :2])
    z = torch.zeros(1, 8, 4, 68, device=cuda, dtype=torch.bfloat16)[..., :64]  # 136-byte rows
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention(z, z[:, :, :2], z[:, :, :2])


@pytest.mark.parametrize("arch", ["llama32_1b", "stablelm_3b"])
def test_engine_through_the_kernel_matches_the_plain_path(cuda, arch):
    """A reduced model served on the card: prefill logits and the engine's
    tokens through the flash kernel agree with the plain attention path
    (f32 weights), and the kernel ran once per layer per admission."""
    cfg = cfgbase.get(arch).reduced()
    params = TF.init_params(0, cfg, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 9, 17, 30)]
    tokens = torch.from_numpy(np.stack([np.resize(p, 32) for p in prompts])).to(cuda)
    logits = {f: SD.prefill(params, cfg, tokens, TF.init_cache(cfg, 4, 32, device=cuda),
                            flash=f)[0] for f in (True, False)}
    torch.testing.assert_close(logits[True], logits[False], rtol=1e-4, atol=1e-4)
    out = {}
    for flash in (True, False):
        eng = Engine(params, cfg, slots=2, cache_len=32, flash=flash)
        for p in prompts:
            eng.submit(p, max_new=6)
        reset_launches()
        out[flash] = eng.run()
        if flash:
            assert LAUNCHES["flash_attention"] == cfg.num_layers * len(prompts)
    assert all(np.array_equal(out[True][r], out[False][r]) for r in out[False])


# -- slice D: LLM-cohort training ---------------------------------------------

# The widest leaf of full-width llama3.2-1b's embedding (128256 x 2048), the
# operating point of the gossip on the full-width LLM path at N=2.
LLAMA_EMBED_D = 262_668_288


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_mix_at_two_nodes_and_full_llm_width(cuda, dtype):
    w = torch.full((2, 2), 0.5, device=cuda)
    w[0, 0], w[0, 1] = 0.75, 0.25
    gen = torch.Generator(device=cuda).manual_seed(2)
    p = (torch.rand(2, LLAMA_EMBED_D, generator=gen, device=cuda) * 2 - 1).to(dtype)
    reset_launches()
    got = gm.gossip_mix(w, p)
    torch.cuda.synchronize()
    assert LAUNCHES["gossip_mix"] == 1 and got.dtype == dtype and got.shape == p.shape
    want = gm.gossip_mix_ref(w, p)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _tol(dtype)["atol"], err
    del p, got, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_kernel_at_two_nodes_one_padded_block(cuda, dtype):
    """N=2: one 8-row block of which 6 rows are padding, at a wide ragged D."""
    csr = sparse.csr_from_graph(topology.make("ring:n=2"))
    b = sparse.block_ell_from_csr(csr)
    assert b.idx.shape[0] == 1  # one block of 8 rows
    idx, val = torch.as_tensor(b.idx, device=cuda), torch.as_tensor(b.val, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = (torch.rand(2, (1 << 25) + 7, generator=gen, device=cuda) * 2 - 1).to(dtype)
    reset_launches()
    got = sg.gossip_mix_sparse_blocked(idx, val, p)
    torch.cuda.synchronize()
    assert LAUNCHES["sparse_gossip_blocked"] == 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), sg.sparse_gossip_blocked_ref(idx, val, p).float(),
                               **_tol(dtype))


def _lm_cfg():
    import dataclasses

    return dataclasses.replace(
        cfgbase.get("llama3.2-1b").reduced(), num_layers=2, d_model=64, num_heads=2,
        num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256)


def _lm(dev, **kw):
    return trainer_mod.LMCohortTrainer("ring:n=4", _lm_cfg(), nodes=4, batch=2, seq=16,
                                       lr=1e-3, device=dev, **kw)


@pytest.mark.parametrize("backend,kw", [
    ("dense", {"compress": 0.25}),
    ("sparse_pallas", {"compress": 0.25}),
    ("sparse_pallas", {"compress": None, "gossip_every": 2}),
    ("dense", {"faults": "churn:p_leave=0.4,p_join=0.3"}),
    ("sparse", {"faults": "churn:p_leave=0.3,p_join=0.3;straggler:frac=0.3,delay=2"}),
])
def test_lm_fused_matches_the_loop_on_the_card(cuda, backend, kw):
    """run_fused (eager first round, then captured CUDA graphs) against run
    at the reference's 1e-6, params and loss; the blocked kernel launched
    once per leaf per gossip round on sparse_pallas."""
    loop, fused = _lm(cuda, backend=backend, **kw), _lm(cuda, backend=backend, **kw)
    h1 = loop.run(6, eval_every=3)
    reset_launches()
    h2 = fused.run_fused(6, eval_every=3)
    for a, b in zip(tree_leaves(loop.params), tree_leaves(fused.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for a, b in zip(h1, h2):
        assert a["round"] == b["round"] and abs(a["loss"] - b["loss"]) <= 1e-6
    if backend == "sparse_pallas":
        gossip_rounds = sum(fused.engine.is_gossip_round(r) for r in range(6))
        assert LAUNCHES["sparse_gossip_blocked"] == len(tree_leaves(fused.params)) * gossip_rounds


def test_lm_dead_nodes_bit_frozen_on_the_card(cuda):
    t = _lm(cuda, faults="churn:p_leave=1.0,p_join=0.0,frac=0.5@targeted=hubs")
    trace = t.engine.fault_trace
    trace.ensure(4)
    dead = np.flatnonzero(~trace.alive_matrix(4).any(axis=0))
    assert dead.size
    before = [x.clone() for x in tree_leaves(t.params) + tree_leaves(t.opt_state)]
    t.run_fused(4, eval_every=4)
    for a, b in zip(before, tree_leaves(t.params) + tree_leaves(t.opt_state)):
        if a.dim() and a.shape[0] == 4:
            assert torch.equal(a[dead], b[dead])


def test_full_width_adamw_step_keeps_its_dtypes(cuda):
    """llama3.2-1b at full width, 2 members: one local step leaves the params
    bf16 and the AdamW moments f32, finite, and moves the params."""
    cfg = cfgbase.get("llama3.2-1b")
    t = trainer_mod.LMCohortTrainer("ring", cfg, nodes=2, compress=None, backend="dense",
                                    device=cuda)
    assert t.member_params == 1_498_482_688
    t._sched = lambda r: torch.tensor(3e-4, device=cuda)
    toks, labels = t._batch(0)
    emb = t.params["embed"][:, :8].clone()
    loss = t._local_step(toks, labels, t._sched(0))
    assert torch.isfinite(loss) and 10.0 < float(loss) < 13.0  # ln(128256) = 11.76
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(t.params))
    opt = t.opt_state
    assert all(m.dtype == torch.float32 for m in tree_leaves(opt.mu) + tree_leaves(opt.nu))
    assert int(opt.count) == 1 and not torch.equal(emb, t.params["embed"][:, :8])
    assert all(bool(torch.isfinite(m).all()) for m in tree_leaves(opt.nu))
    del t, opt, emb
    gc.collect()
    torch.cuda.empty_cache()


# -- slice G: the rest of the model zoo -----------------------------------------

ZOO = ["jamba_v01_52b", "dbrx_132b", "arctic_480b", "rwkv6_3b", "whisper_base", "internvl2_76b"]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_forward_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced model (f32, weights drawn on the CPU) on the card and on
    the CPU: logits at 1e-4, the MoE aux at 1e-5."""
    from repro_torch.models import frontends

    cfg = cfgbase.get(arch).reduced()
    params = TF.init_params(0, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40)))
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        kw = {}
        if cfg.enc_dec:
            frames = frontends.audio_frames(torch.Generator().manual_seed(2), cfg, 2, 30)
            kw["memory"] = TF.encode(p, cfg, frames.to(dev))
        if cfg.family == "vlm":
            kw["prefix_embeds"] = frontends.patch_embeddings(
                torch.Generator().manual_seed(3), cfg, 2, 8).to(dev)
        logits, aux = TF.forward(p, cfg, toks.to(dev), **kw)
        out[str(dev)] = (logits.cpu(), aux.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "b,s,h,hkv,hd",
    [(1, 512, 48, 8, 128), (1, 512, 56, 8, 128), (1, 512, 64, 8, 128), (2, 333, 56, 8, 128)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_zoo_gqa_groups(cuda, b, s, h, hkv, hd, dtype):
    """dbrx's, arctic's and internvl2's prefill heads: head dim 128, GQA
    groups 6, 7 (odd: its last block of query heads is half empty) and 8."""
    gen = torch.Generator(device=cuda).manual_seed(s + h)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=cuda).to(dtype)
               for n in (h, hkv, hkv))
    reset_launches()
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    tol = 3e-2 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(got.float(), fa.flash_attention_ref(q, k, v).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["dbrx_132b", "arctic_480b", "internvl2_76b"])
def test_zoo_engine_through_the_kernel_matches_the_plain_path(cuda, arch):
    """The attention-only zoo archs (reduced, f32) through the Engine: the
    kernel ran once per layer per admission, and its tokens are the plain
    path's."""
    cfg = cfgbase.get(arch).reduced()
    params = TF.init_params(0, cfg, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 9, 17, 30)]
    out = {}
    for flash in (True, False):
        eng = Engine(params, cfg, slots=2, cache_len=32, flash=flash)
        for p in prompts:
            eng.submit(p, max_new=6)
        reset_launches()
        out[flash] = eng.run()
        if flash:
            assert LAUNCHES["flash_attention"] == cfg.num_layers * len(prompts)
    assert all(np.array_equal(out[True][r], out[False][r]) for r in out[False])


@pytest.mark.parametrize("arch", ["jamba_v01_52b", "dbrx_132b", "rwkv6_3b", "internvl2_76b"])
def test_zoo_lm_fused_matches_the_loop_on_the_card(cuda, arch):
    """Reduced zoo members (CHOCO on: auto) on sparse_pallas: the fused
    path captures the MoE dispatch and the Mamba / RWKV scans in CUDA
    graphs, and agrees with the loop at 1e-6; the blocked kernel ran once
    per leaf per gossip round."""
    cfg = cfgbase.get(arch).reduced()
    kw = dict(nodes=4, batch=2, seq=16, lr=1e-3, backend="sparse_pallas", device=cuda)
    loop = trainer_mod.LMCohortTrainer("ring:n=4", cfg, **kw)
    fused = trainer_mod.LMCohortTrainer("ring:n=4", cfg, **kw)
    h1 = loop.run(3, eval_every=3)
    reset_launches()
    h2 = fused.run_fused(3, eval_every=3)
    assert LAUNCHES["sparse_gossip_blocked"] == 3 * len(tree_leaves(fused.params))
    for a, b in zip(tree_leaves(loop.params), tree_leaves(fused.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert abs(h1[-1]["loss"] - h2[-1]["loss"]) <= 1e-6


# -- slice G2: step builders and pipeline-parallel decode ---------------------------


def _pipe_cfg():
    import dataclasses

    return dataclasses.replace(cfgbase.get("llama3.2-1b").reduced(), num_layers=4, num_heads=4,
                               num_kv_heads=2, head_dim=32, d_model=128, d_ff=256,
                               vocab_size=512)


@pytest.mark.parametrize("variant", ["auto_2x2", "auto_4x1", "manual_2x2", "manual_pod2x2x2",
                                     "manual_1x4"])
def test_pipeline_decode_on_the_card_matches_the_serve_step(cuda, variant):
    """Both pipeline variants (reduced llama, f32, every mesh position on the
    card) choose build_serve_step's tokens over 6 steps, teacher-forced; the
    auto variant's cache within 1e-5 of the serve step's, the manual one's
    within one int8 level of the int8 serve step's."""
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import steps as ST
    from repro_torch.serve import pipeline as PL
    from repro_torch.serve import pipeline_manual as PM

    cfg = _pipe_cfg()
    params = TF.init_params(0, cfg, device=cuda)
    kind, shape = variant.split("_")
    axes = ("pod", "data", "model") if shape.startswith("pod") else ("data", "model")
    shape = tuple(int(x) for x in shape.removeprefix("pod").split("x"))
    mesh_ = LM.make_host_mesh(shape, axes, device=cuda)
    manual = kind == "manual"
    b, t_len = 4, 16
    serve = ST.build_serve_step(cfg)
    want = TF.init_cache(cfg, b, t_len, kv_quant=manual, device=cuda)
    step = PL.build_pipeline_step(cfg, mesh_, manual=manual)
    tp = mesh_.shape["model"]
    got = (PM.init_kv_cache(cfg, b, t_len, tp=tp, device=cuda) if manual
           else TF.init_cache(cfg, b, t_len, device=cuda))
    tok = torch.arange(1, b + 1, dtype=torch.int32, device=cuda)
    for _ in range(6):
        ref, want = serve(params, tok, want)
        out, got = step(params, tok, got)
        assert torch.equal(out, ref)
        tok = ref
    mix = want["layer0"]["mixer"]
    if manual:
        heads = PM.kv_heads(cfg, tp)
        for k in ("k", "v"):
            assert int((got[k].int() - mix[k][:, :, :, heads].int()).abs().max()) <= 1
        torch.testing.assert_close(got["k_scale"], mix["k_scale"][:, :, :, heads],
                                   rtol=1e-5, atol=0)
        assert bool((got["index"] == 6).all())
    else:
        for k in ("k", "v"):
            torch.testing.assert_close(got["layer0"]["mixer"][k], mix[k], rtol=0, atol=1e-5)
        assert bool((got["layer0"]["mixer"]["index"] == 6).all())


def test_train_and_prefill_steps_on_the_card(cuda):
    """build_train_step (reduced llama, 2 members, AdamW, 2 microbatches)
    lowers the loss on one batch; build_prefill_step's tokens are
    generate's first."""
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    cfg = cfgbase.get("llama3.2-1b").reduced()
    member = TF.init_params(0, cfg, device=cuda)
    params = tree_map(lambda x: torch.stack([x] * 2), member)
    opt = adamw.init(params)
    gen = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 2, 33), generator=gen, device=cuda)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    step = ST.build_train_step(cfg, num_nodes=2, microbatches=2, lr=1e-3)
    w = torch.full((2, 2), 0.5, device=cuda)
    losses = []
    for _ in range(4):
        params, opt, loss = step(params, opt, w, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    prompts = torch.randint(0, cfg.vocab_size, (3, 20), generator=gen, device=cuda)
    first = ST.build_prefill_step(cfg)(member, {"tokens": prompts})
    want = SD.generate(member, cfg, prompts, TF.init_cache(cfg, 3, 21, device=cuda), steps=1)
    assert torch.equal(first, want[:, 0])


def test_machine_fingerprint_on_the_card(cuda):
    """The fingerprint names every card and its power limit (nvidia-smi),
    and two calls give equal dicts."""
    from repro_torch.core.machine import machine_fingerprint

    fp = machine_fingerprint()
    n = torch.cuda.device_count()
    assert fp["backend"] == "cuda" and fp["cuda"] == torch.version.cuda
    assert fp["devices"] == [torch.cuda.get_device_name(i) for i in range(n)]
    assert len(fp["power_limit"]) == n and all(p.endswith(" W") for p in fp["power_limit"])
    assert machine_fingerprint() == fp


@pytest.mark.parametrize("fused", [False, True], ids=["run", "run_fused"])
def test_trainer_w_follows_the_schedule_on_the_card(cuda, fused):
    """``DecentralizedTrainer.w`` on the card is the CPU trainer's W after
    every round of an @rewire schedule."""
    rng = np.random.default_rng(0)
    x = rng.random((80, 16), dtype=np.float32)
    y = np.arange(80) % 4
    parts = [np.arange(8 * i, 8 * i + 8) for i in range(10)]
    ws = {}
    for dev in ("cpu", cuda):
        loader = NodeLoader(x, y, parts, batch_size=4, device=dev)
        tr = trainer_mod.DecentralizedTrainer(
            "er:n=10,p=0.5@rewire=2", loader, in_dim=16, hidden=(8,), num_classes=4,
            device=dev)
        got = [tr.w.cpu()]
        (tr.run_fused if fused else tr.run)(6, eval_every=1, x_test=x, y_test=y,
                                            on_round=lambda m: got.append(tr.w.cpu()))
        ws[str(dev)] = got
    assert len({w.numpy().tobytes() for w in ws["cpu"]}) > 1
    for a, b in zip(ws["cpu"], ws["cuda"]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-7)


def test_auto_int8_pipeline_matches_the_microgroup_control_on_the_card(cuda):
    """The auto pipeline (reduced widths, 16 layers, (4, 2), int8, batch 8,
    16 steps fed the serve step's tokens): its whole cache within one level
    of build_serve_step run over each microgroup's 2 rows alone, the caches
    concatenated (scales 1e-5 relative)."""
    import dataclasses

    from repro_torch.launch import mesh as LM
    from repro_torch.launch import steps as ST
    from repro_torch.serve import pipeline as PL

    cfg = dataclasses.replace(_pipe_cfg(), num_layers=16)
    params = TF.init_params(0, cfg, device=cuda)
    b, t_len, stages = 8, 16, 4
    serve = ST.build_serve_step(cfg)
    cache = TF.init_cache(cfg, b, t_len, kv_quant=True, device=cuda)
    fed, tok = [], torch.arange(1, b + 1, dtype=torch.int32, device=cuda)
    for _ in range(16):
        fed.append(tok)
        tok, cache = serve(params, tok, cache)
    step = PL.build_pipeline_step(cfg, LM.make_host_mesh((stages, 2), device=cuda))
    got = TF.init_cache(cfg, b, t_len, kv_quant=True, device=cuda)
    for t in fed:
        _, got = step(params, t, got)
    mb, parts = b // stages, []
    for m in range(stages):
        c = TF.init_cache(cfg, mb, t_len, kv_quant=True, device=cuda)
        for t in fed:
            _, c = serve(params, t[m * mb:(m + 1) * mb], c)
        parts.append(c["layer0"]["mixer"])
    got = got["layer0"]["mixer"]
    for k in ("k", "v"):
        want = torch.cat([p[k] for p in parts], dim=1)
        assert int((got[k].int() - want.int()).abs().max()) <= 1
    for k in ("k_scale", "v_scale"):
        torch.testing.assert_close(got[k], torch.cat([p[k] for p in parts], dim=1),
                                   rtol=1e-5, atol=0)
