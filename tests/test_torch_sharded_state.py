"""The DecAvg trainer's ``run_fused`` on ``sparse_sharded`` holds its node
state as per-shard slabs from the first round to the last.

Here the mesh is 8 shards of the CPU, which runs every line that distinct
devices run but the copies between them. The sharded run gives the port's
own ``sparse`` bits, loop and fused (N=24 and a ring N=32; both halo
schedules; static and ``@rewire``; gossip every round and every third;
plain, churn, stragglers with delay 2 and CHOCO 0.25). Wrapping
``core.mesh``'s collectives shows what crosses between shards: in a round,
each shard receives exactly ``sparse.halo_wire_bytes`` of the round's
leaves, and nothing crosses during the local steps, whose slabs are tensors
of their own of N/S nodes.
"""

import numpy as np
import pytest
import torch

from repro.core import partition as ref_partition
from repro.data.synthetic import make_mnist_like
from repro_torch.core import mesh, sparse
from repro_torch.data.loader import NodeLoader
from repro_torch.train import metrics
from repro_torch.train.trainer import DecentralizedTrainer
from repro_torch.tree import tree_leaves

BATCH, DIM, HIDDEN, SHARDS = 8, 32, (16,), 8
CPU = torch.device("cpu")
TOPOLOGIES = {
    "ws24": "ws:n=24,k=4,beta=0.2",
    "ba24_rewire": "ba:n=24,m=2@rewire=2",
    "ring32": "ring:n=32",
}
MODES = {
    "plain": {},
    "churn": {"faults": "churn:p_leave=0.2,p_join=0.3;drop:p_edge=0.1"},
    "stragglers": {"faults": "churn:p_leave=0.2,p_join=0.3;straggler:frac=0.25,delay=2;"
                             "drop:p_edge=0.1"},
    "choco": {"compress": 0.25},
}
COLLECTIVES = ("all_gather", "psum", "psum_scatter", "ppermute")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small operations: one intra-op thread is faster for them and
    keeps the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_DATA: dict[int, tuple] = {}


def _data(n: int):
    if n not in _DATA:
        ds = make_mnist_like(train_per_class=48, test_per_class=10, dim=DIM, seed=0)
        _DATA[n] = (ds, ref_partition.iid(ds.y_train, n, seed=1))
    return _DATA[n]


def _nodes(spec: str) -> int:
    return int(spec.split("n=")[1].split(",")[0].split("@")[0])


def _trainer(spec, backend, shards=None, halo="auto", **kw):
    ds, parts = _data(_nodes(spec))
    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2, device="cpu")
    tr = DecentralizedTrainer(spec, loader, lr=0.05, momentum=0.9, mix_impl=backend, seed=0,
                              in_dim=DIM, hidden=HIDDEN, device="cpu", **kw)
    if shards is not None:
        tr.engine.mesh = mesh.Mesh([CPU] * shards, ("data",))
        tr.engine.halo_schedule = halo
    return tr, ds


def _state(tr) -> list[torch.Tensor]:
    out = tree_leaves(tr.params) + tree_leaves(tr.momentum)
    if tr.cstate is not None:
        out += tree_leaves(tr.cstate.reference)
    return out


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("gossip_every", [1, 3])
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_sharded_state_gives_the_sparse_bits(topology, gossip_every, mode):
    """sparse's loop and fused runs, and sparse_sharded's fused run on 8
    shards under each halo schedule: one set of bits (params, momentum,
    the CHOCO reference) and the same per-node accuracies; consensus is
    summed a shard at a time, so it is held to 1e-6."""
    spec, kw = TOPOLOGIES[topology], dict(MODES[mode], gossip_every=gossip_every)
    runs, hist = {}, {}
    for name, backend, shards, halo, path in (
        ("sparse run", "sparse", None, "auto", "run"),
        ("sparse fused", "sparse", None, "auto", "run_fused"),
        ("ring", "sparse_sharded", SHARDS, "ring", "run_fused"),
        ("allgather", "sparse_sharded", SHARDS, "allgather", "run_fused"),
    ):
        tr, ds = _trainer(spec, backend, shards, halo, **kw)
        hist[name] = getattr(tr, path)(5, eval_every=2, x_test=ds.x_test, y_test=ds.y_test)
        runs[name] = _state(tr)
    for name in runs:
        assert _same(runs[name], runs["sparse run"]), name
        assert [m.round for m in hist[name]] == [0, 2, 4]
        for got, want in zip(hist[name], hist["sparse fused"]):
            np.testing.assert_array_equal(got.per_node_acc, want.per_node_acc)
            np.testing.assert_array_equal(got.group_acc, want.group_acc)
            np.testing.assert_allclose(got.consensus, want.consensus, rtol=1e-6, atol=0)


def _watch(monkeypatch):
    """Record the run's events in order: each local step (with the slab
    tree it trains) and, for each collective, the bytes each receiving
    shard takes from another shard index."""
    events: list[tuple] = []
    orig = {name: getattr(mesh, name) for name in COLLECTIVES}

    def ppermute(slabs, pairs, devices):
        for src, dst in pairs:
            if src != dst:
                events.append(("bytes", "ppermute", dst, slabs[src].nbytes))
        return orig["ppermute"](slabs, pairs, devices)

    def all_gather(slabs, device, *, axis=0, shard=None):
        # Every shard's slab but the receiver's own (they are equal in size).
        events.append(("bytes", "all_gather", None, sum(s.nbytes for s in slabs[1:])))
        return orig["all_gather"](slabs, device, axis=axis, shard=shard)

    def psum(parts, devices):
        events.append(("bytes", "psum", None, sum(p.nbytes for p in parts[1:])))
        return orig["psum"](parts, devices)

    def psum_scatter(parts, devices):
        events.append(("bytes", "psum_scatter", None, sum(p.nbytes for p in parts)))
        return orig["psum_scatter"](parts, devices)

    for name, fn in (("ppermute", ppermute), ("all_gather", all_gather), ("psum", psum),
                     ("psum_scatter", psum_scatter)):
        monkeypatch.setattr(mesh, name, fn)
    step = DecentralizedTrainer._sgd_step

    def sgd_step(self, params, momentum, x, y):
        events.append(("step", params, momentum, x.shape[0]))
        return step(self, params, momentum, x, y)

    monkeypatch.setattr(DecentralizedTrainer, "_sgd_step", sgd_step)
    return events


def _rounds(events: list[tuple]) -> list[tuple[list, list]]:
    """The events cut into rounds: each round's local steps, then what the
    collectives moved until the next round's first step."""
    out: list[tuple[list, list]] = []
    for ev in events:
        if ev[0] == "step":
            if not out or out[-1][1]:
                out.append(([], []))
            out[-1][0].append(ev)
        else:
            assert out, "bytes moved before the first local step"
            out[-1][1].append(ev)
    return out


@pytest.mark.parametrize("mode", ["plain", "stragglers"])
@pytest.mark.parametrize("halo", ["ring", "allgather"])
@pytest.mark.parametrize("topology", ["ws24", "ring32"])
def test_only_the_halo_crosses_between_shards(monkeypatch, topology, halo, mode):
    """In each round of a sharded run_fused, the local steps train 8 slabs
    of N/8 nodes, each a tensor of its own held from the first round to the
    last, and move nothing between shards; then the halo exchange brings
    each shard exactly ``halo_wire_bytes`` of the round's leaves, and
    nothing else crosses."""
    spec = TOPOLOGIES[topology]
    tr, _ = _trainer(spec, "sparse_sharded", SHARDS, halo, **MODES[mode])
    n, blk = tr.num_nodes, tr.num_nodes // SHARDS
    p = sum(leaf[0].numel() for leaf in tree_leaves(tr.params))
    wire = sparse.halo_wire_bytes(tr.engine.sharded_csr(), p)[halo]
    home = {t.data_ptr() for t in _state(tr)}
    events = _watch(monkeypatch)
    tr.run_fused(4)
    rounds = _rounds(events)
    steps = tr.loader.steps_per_epoch()
    assert len(rounds) == 4
    slab_ptrs = None
    for local, moved in rounds:
        assert len(local) == SHARDS * steps
        ptrs = []
        for _, params, momentum, nodes in local:
            leaves = tree_leaves(params) + tree_leaves(momentum)
            assert nodes == blk and all(leaf.shape[0] == blk for leaf in leaves)
            ptrs.append(tuple(leaf.data_ptr() for leaf in leaves))
        shard_ptrs = ptrs[::steps]
        assert len({q for t in shard_ptrs for q in t}) == SHARDS * len(shard_ptrs[0])
        assert not home & {q for t in shard_ptrs for q in t}
        slab_ptrs = slab_ptrs or shard_ptrs
        assert shard_ptrs == slab_ptrs  # the same slabs every round
        kinds = {ev[1] for ev in moved}
        assert kinds == {"ppermute" if halo == "ring" else "all_gather"}
        if halo == "ring":
            per_shard = [sum(ev[3] for ev in moved if ev[2] == s) for s in range(SHARDS)]
            assert per_shard == [wire] * SHARDS
        else:
            assert [ev[3] for ev in moved] == [wire] * SHARDS == [(n - blk) * p * 4] * SHARDS


def test_the_loop_moves_each_periods_halo(monkeypatch):
    """The loop keeps the state on the trainer's device and each mix moves
    the slabs out and back: per gossip round, each shard receives the
    current period's ``halo_wire_bytes`` over the ring."""
    tr, _ = _trainer(TOPOLOGIES["ba24_rewire"], "sparse_sharded", SHARDS, "ring")
    p = sum(leaf[0].numel() for leaf in tree_leaves(tr.params))
    events = _watch(monkeypatch)
    tr.run(4)
    rounds = _rounds(events)
    assert len(rounds) == 4
    for r, (local, moved) in enumerate(rounds):
        assert all(nodes == tr.num_nodes for *_, nodes in local)  # unsharded steps
        tr.engine.refresh(r)
        wire = sparse.halo_wire_bytes(tr.engine.sharded_csr(), p)["ring"]
        assert [sum(ev[3] for ev in moved if ev[2] == s) for s in range(SHARDS)] == [wire] * SHARDS


@pytest.mark.parametrize("faults", [None, "stragglers"])
def test_apply_local_is_the_gathered_mix(faults):
    """``MixingProgram.apply_local`` over scattered slabs (each shard's tree
    in, its mixed tree out, nothing gathered) gives ``apply``'s bits on the
    whole node axis, published snapshots too; ``mix_at_local`` skips the
    rounds the cadence skips."""
    kw = {} if faults is None else {"faults": MODES[faults]["faults"]}
    tr, _ = _trainer(TOPOLOGIES["ba24_rewire"], "sparse_sharded", SHARDS, "ring",
                     gossip_every=2, **kw)
    prog = tr.engine.program(4)
    devices = prog.shard_devices
    gen = torch.Generator().manual_seed(5)
    params = {"a": torch.randn(24, 3, 2, generator=gen), "b": torch.randn(24, 5, generator=gen)}
    pub = None if faults is None else {k: torch.randn(v.shape, generator=gen)
                                       for k, v in params.items()}

    def scatter(tree):
        per = {k: mesh.scatter(v, devices) for k, v in tree.items()}
        return [{k: per[k][s] for k in tree} for s in range(SHARDS)]

    for r in range(4):
        got = prog.mix_at_local(scatter(params), r, None if pub is None else scatter(pub))
        whole = {k: mesh.gather([g[k] for g in got], CPU) for k in params}
        want = prog.mix_at(params, r, pub)
        assert all(torch.equal(whole[k], want[k]) for k in params), r
        assert all(g["a"].shape == (3, 3, 2) for g in got)


def test_scatter_gather_and_sharded_consensus():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(24, 4, 3, generator=gen)
    slabs = mesh.scatter(x, [CPU] * SHARDS)
    assert [s.shape for s in slabs] == [(3, 4, 3)] * SHARDS
    assert len({s.data_ptr() for s in slabs} | {x.data_ptr()}) == SHARDS + 1
    assert torch.equal(mesh.gather(slabs, CPU), x)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.scatter(x, [CPU] * 5)
    tree = {"w": x, "b": torch.randn(24, 7, generator=gen)}
    parts = [{"w": w, "b": b} for w, b in zip(slabs, mesh.scatter(tree["b"], [CPU] * SHARDS))]
    whole = metrics.consensus_distance(tree)
    assert torch.equal(metrics.sharded_consensus_distance([tree], CPU), whole)
    torch.testing.assert_close(metrics.sharded_consensus_distance(parts, CPU), whole,
                               rtol=1e-6, atol=0)


def test_a_second_call_continues_from_the_gathered_state():
    """run_fused gathers the params, momentum and CHOCO reference back into
    the trainer's own tensors when its rounds are done, so a second call
    starts where the first ended, as sparse's does."""
    runs = {}
    for name, backend, shards in (("sparse", "sparse", None), ("sharded", "sparse_sharded", 8)):
        tr, _ = _trainer(TOPOLOGIES["ws24"], backend, shards, "ring", compress=0.25)
        tensors = _state(tr)
        tr.run_fused(3)
        tr.run_fused(2)
        assert all(a is b for a, b in zip(_state(tr), tensors))
        runs[name] = _state(tr)
    assert _same(runs["sharded"], runs["sparse"])


def test_program_stages_each_shards_views_on_its_device():
    tr, _ = _trainer(TOPOLOGIES["ba24_rewire"], "sparse_sharded", SHARDS, "ring",
                     faults=MODES["stragglers"]["faults"])
    prog = tr.engine.program(5)
    assert len(prog.sh_views) == prog.num_periods == 3
    assert all(len(views) == SHARDS for views in prog.sh_views)
    assert [f.alive.shape for f in prog.sh_faults] == [(5, 3)] * SHARDS
    for s, f in enumerate(prog.sh_faults):
        assert torch.equal(f.keep, prog.f_keep[:, s]) and torch.equal(f.delay, prog.f_delay[s * 3:s * 3 + 3])
    for t, views in enumerate(prog.sh_views):
        for s, v in enumerate(views):
            w = prog.sh_widths[s]
            assert torch.equal(v.idx, prog.sh_ell_idx[t, s, :, :w]) and v.idx.is_contiguous()
            assert v.ring_dists == tuple(d for d, a in enumerate(prog.sh_ring_send, 1)
                                         if a.shape[-1])
            assert torch.equal(v.halo, prog.sh_halo[t, s])
    assert prog.ring and prog.shard_devices == [CPU] * SHARDS
