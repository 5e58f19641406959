"""The LLM cohort's state sharded over a mesh on ``sparse_sharded``, held to
the port's own ``sparse`` cohort.

The mesh is 2 or 4 shards of the CPU, which runs every line that distinct
devices run but the copies between them. Tiny llama members (2 layers,
d_model 64, vocab 256), 8 of them. The sharded cohort gives ``sparse``'s
bits for the params, both AdamW moments, the CHOCO references, each
record's loss and ``domain_acc`` and the consensus: plain, CHOCO 0.25,
churn, stragglers with delay 2, gossip every third round and a rewired BA
graph. Its state stays per-shard slabs on the shards' devices across
``run`` calls; wrapping ``core.mesh``'s collectives shows that nothing
crosses between shards during the local steps and a gossip round moves each
leaf's ``halo_wire_bytes``; checkpoints restore across sharded and
unsharded cohorts bit for bit; assigning ``params`` scatters.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.core import mesh, sparse
from repro_torch.experiments import runner
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.store import ResultsStore
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.trainer import LMCohortTrainer
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small operations: one intra-op thread is faster for them and
    keeps the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, ROUNDS = 8, 4
CPU = torch.device("cpu")
TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
            vocab_size=256)
MODES = {
    "plain": {},
    "choco": {"compress": 0.25},
    "churn": {"faults": "churn:p_leave=0.3,p_join=0.3;drop:p_edge=0.1"},
    "stragglers": {"faults": "churn:p_leave=0.2,p_join=0.3;straggler:frac=0.25,delay=2"},
    "gossip_every_3": {"gossip_every": 3},
    "rewire": {"topology": "ba:n=8,m=2@rewire=2"},
}
COLLECTIVES = ("all_gather", "psum", "psum_rows", "psum_scatter", "ppermute")


def _cfg(**kw):
    return dataclasses.replace(cfgbase.get("llama32_1b").reduced(), **TINY, **kw)


def _cohort(backend, shards=None, topology="ring:n=8", optimizer="adamw", **kw):
    m = None if shards is None else mesh.Mesh([CPU] * shards, ("data",))
    return LMCohortTrainer(topology, _cfg(optimizer=optimizer), nodes=N, batch=2, seq=16,
                           lr=1e-3, backend=backend, mesh=m, device="cpu", **kw)


def _state(tr) -> list[torch.Tensor]:
    out = tree_leaves(tr.params) + tree_leaves(tr.opt_state)
    if tr.cstate is not None:
        out += tree_leaves(tr.cstate.reference)
    return out


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


_SPARSE: dict[str, tuple] = {}


def _sparse_run(mode: str):
    """The ``sparse`` cohort's run of ``mode``: its state, records and
    consensus (cached: every shard count is held to the same run)."""
    if mode not in _SPARSE:
        tr = _cohort("sparse", **MODES[mode])
        hist = tr.run(ROUNDS)
        _SPARSE[mode] = (_state(tr), hist, tr.consensus())
    return _SPARSE[mode]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_sharded_cohort_gives_the_sparse_bits(mode, shards):
    """Params, both moments, CHOCO's references, every record's loss, lr
    and domain_acc, and the consensus: sparse's, bit for bit."""
    want_state, want_hist, want_cons = _sparse_run(mode)
    tr = _cohort("sparse_sharded", shards, **MODES[mode])
    assert tr.sharded and tr.shards == shards
    hist = tr.run(ROUNDS)
    assert _same(_state(tr), want_state)
    assert [r["round"] for r in hist] == [r["round"] for r in want_hist] == list(range(ROUNDS))
    for got, want in zip(hist, want_hist):
        assert set(got) == set(want)
        for key in ("loss", "lr", "domain_acc", "g2_token_spread", "alive_count"):
            assert got.get(key) == want.get(key), key
    np.testing.assert_array_equal(tr.consensus(), want_cons)


@pytest.mark.parametrize("nodes", [2, 4])
def test_one_member_a_shard_gives_the_sparse_bits(nodes):
    """One member a shard, every shard on one device (as phase 17c runs 2
    full-width members on 2 shards of one card): each shard's slabs are
    tensors of their own, and the cohort gives sparse's bits."""
    kw = dict(nodes=nodes, batch=2, seq=16, lr=1e-3, compress=0.25, device="cpu")
    want = LMCohortTrainer(f"ring:n={nodes}", _cfg(), backend="sparse", **kw)
    tr = LMCohortTrainer(f"ring:n={nodes}", _cfg(), backend="sparse_sharded",
                         mesh=mesh.Mesh([CPU] * nodes, ("data",)), **kw)
    ptrs = [p for s in _slab_ptrs(tr) for p in s]
    assert len(set(ptrs)) == len(ptrs)
    h_want, h = want.run(3), tr.run(3)
    assert [r["loss"] for r in h] == [r["loss"] for r in h_want]
    assert _same(_state(tr), _state(want))


def _slab_ptrs(tr) -> list[list[int]]:
    parts = [tr._p, tr._o] + ([tr._c] if tr._c is not None else [])
    return [[x.data_ptr() for t in trees for x in tree_leaves(t)] for trees in zip(*parts)]


@pytest.mark.parametrize("shards", [2, 4])
def test_the_state_stays_sharded_between_runs(shards):
    """After construction, run(2) and a second run(4), every params,
    moments and reference leaf is a slab of N/S nodes on its shard's mesh
    device, the same tensors throughout (no whole leaf is ever put back),
    and the two calls give sparse's bits."""
    tr = _cohort("sparse_sharded", shards, compress=0.25)
    want = _cohort("sparse", compress=0.25)
    devices = tr.engine.shard_devices
    ptrs = _slab_ptrs(tr)
    assert len(ptrs) == shards and len({p for s in ptrs for p in s}) == sum(map(len, ptrs))
    for rounds in (2, 4):
        tr.run(rounds)
        want.run(rounds)
        assert _slab_ptrs(tr) == ptrs
        for s, d in enumerate(devices):
            leaves = (tree_leaves(tr._p[s]) + tree_leaves(tr._o[s].mu) + tree_leaves(tr._o[s].nu)
                      + tree_leaves(tr._c[s].reference))
            assert all(x.shape[0] == N // shards and x.device == d for x in leaves)
            assert tr._o[s].count.dim() == 0 and int(tr._o[s].count) == int(want.opt_state.count)
        assert _same(_state(tr), _state(want))


def _watch(monkeypatch):
    """Record the run's events in order: each local step (the nodes it
    trains) and, for each collective, the bytes each receiving shard takes
    from another shard index."""
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

    def other(name):
        def fn(parts, devices):
            events.append(("bytes", name, None, sum(p.nbytes for p in parts[1:])))
            return orig[name](parts, devices)
        return fn

    monkeypatch.setattr(mesh, "ppermute", ppermute)
    monkeypatch.setattr(mesh, "all_gather", all_gather)
    for name in ("psum", "psum_rows", "psum_scatter"):
        monkeypatch.setattr(mesh, name, other(name))
    step = LMCohortTrainer._local_step

    def local_step(self, params, opt, toks, labels, lr):
        events.append(("step", tree_leaves(params)[0].shape[0], toks.shape[0]))
        return step(self, params, opt, toks, labels, lr)

    monkeypatch.setattr(LMCohortTrainer, "_local_step", local_step)
    return events


@pytest.mark.parametrize("compress", [None, 0.25])
@pytest.mark.parametrize("halo", ["ring", "allgather"])
def test_only_the_halo_crosses_between_shards(monkeypatch, halo, compress):
    """Each round: 4 local steps of N/4 nodes (their slabs and token rows),
    nothing crossing between shards meanwhile; then the gossip, leaf by
    leaf, brings each shard exactly ``halo_wire_bytes`` of each leaf, and
    nothing else crosses."""
    shards = 4
    tr = _cohort("sparse_sharded", shards, compress=compress)
    tr.engine.halo_schedule = halo
    shcsr = tr.engine.sharded_csr()
    widths = [x[0].numel() for x in tree_leaves(tr._p[0])]
    want = [sparse.halo_wire_bytes(shcsr, p)[halo] for p in widths]
    events = _watch(monkeypatch)
    tr.run(3)
    rounds: list[tuple[list, list]] = []
    for ev in events:
        if ev[0] == "step":
            if not rounds or rounds[-1][1]:
                rounds.append(([], []))
            rounds[-1][0].append(ev)
        else:
            assert rounds, "bytes moved before the first local step"
            rounds[-1][1].append(ev)
    assert len(rounds) == 3
    for local, moved in rounds:
        assert local == [("step", N // shards, N // shards)] * shards
        kinds = {ev[1] for ev in moved}
        assert kinds == {"ppermute" if halo == "ring" else "all_gather"}
        if halo == "ring":
            # Each leaf's ring steps, one per distance; per shard, per leaf.
            per_leaf = len(moved) // len(widths)
            for j, w in enumerate(want):
                chunk = moved[j * per_leaf:(j + 1) * per_leaf]
                assert [sum(ev[3] for ev in chunk if ev[2] == s) for s in range(shards)] \
                    == [w] * shards
        else:
            assert [ev[3] for ev in moved] == [w for w in want for _ in range(shards)]


@pytest.mark.parametrize("direction", ["sharded_to_unsharded", "unsharded_to_sharded"])
def test_checkpoints_cross_between_sharded_and_unsharded(tmp_path, direction):
    """A checkpoint of either kind restores into the other bit for bit
    (params, moments and count, CHOCO references), and the resumed run
    ends on the uninterrupted run's bits."""
    path = str(tmp_path / "ck.npz")
    writer, reader = (("sparse_sharded", 4), ("sparse", None))
    if direction == "unsharded_to_sharded":
        writer, reader = reader, writer
    a = _cohort(writer[0], writer[1], compress=0.25)
    a.run(3, ckpt_every=2, ckpt_path=path)
    b = _cohort(reader[0], reader[1], compress=0.25)
    assert b.restore(path) == 3
    assert _same(_state(b), _state(a))
    assert int(b.opt_state.count) == int(a.opt_state.count) == 3
    a.start_round = 3
    a.run(5)
    b.run(5)
    assert _same(_state(b), _state(a))
    whole = _cohort("sparse", compress=0.25)
    whole.run(3)
    whole.start_round = 3
    whole.run(5)
    assert _same(_state(b), _state(whole))


def test_assigning_the_state_scatters_it():
    """``params = tree`` (as the reference-parity tests assign it) cuts the
    tree into each shard's rows, copies of their own; reading gives the
    tree back, gathered on the trainer's device. opt_state and cstate
    alike."""
    tr = _cohort("sparse_sharded", 4, compress=0.25)
    gen = torch.Generator().manual_seed(3)
    tree = tr.params
    params = [torch.randn(x.shape, generator=gen) for x in tree_leaves(tree)]
    for x, y in zip(tree_leaves(tree), params):
        x.copy_(y)
    tr.params = tree
    assert _same(tree_leaves(tr.params), params)
    given = {x.data_ptr() for x in tree_leaves(tree)}
    for s in range(4):
        slabs = tree_leaves(tr._p[s])
        assert all(x.shape[0] == N // 4 for x in slabs)
        assert not given & {x.data_ptr() for x in slabs}
        assert all(torch.equal(x, p[2 * s:2 * s + 2]) for x, p in zip(slabs, params))
    state = adamw.init(tr.params)
    state.count.fill_(7)
    tr.opt_state = state
    assert [int(o.count) for o in tr._o] == [7] * 4 and int(tr.opt_state.count) == 7
    assert isinstance(tr.opt_state, adamw.AdamWState)
    tr.cstate = None
    assert tr.cstate is None and tr._c is None


def test_a_replaced_mesh_re_places_the_state():
    """``engine.mesh`` assigned after construction: the next run re-places
    the state on the new mesh's shards, through the host, and keeps
    sparse's bits."""
    tr = _cohort("sparse_sharded", 2)
    tr.engine.mesh = mesh.Mesh([CPU] * 4, ("data",))
    tr.run(2)
    assert tr.shards == 4 and all(x.shape[0] == 2 for x in tree_leaves(tr._p[3]))
    want = _cohort("sparse")
    want.run(2)
    assert _same(_state(tr), _state(want))


def test_run_fused_refuses_sparse_sharded_as_the_reference():
    tr = _cohort("sparse_sharded", 2)
    assert not tr.supports_fused
    with pytest.raises(ValueError, match="run_fused supports backends"):
        tr.run_fused(2)


def test_sgd_cohort_shards_its_momentum():
    tr = _cohort("sparse_sharded", 4, optimizer="sgd", schedule="const")
    want = _cohort("sparse", optimizer="sgd", schedule="const")
    tr.run(3)
    want.run(3)
    assert all(x.shape[0] == 2 for o in tr._o for x in tree_leaves(o))
    assert _same(_state(tr), _state(want))


def test_the_runner_reaches_the_sharded_state(tmp_path, monkeypatch, capsys):
    """``--mix-backend sparse_sharded`` through run_spec: the trainer holds
    its cohort sharded on the default mesh (here 2 shards of the CPU), runs
    the loop (run_fused refuses the backend, as the reference's), prints
    its shard count, and writes sparse's records in the reference's
    schema."""
    made = []

    class Capture(LMCohortTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(trainer_mod, "LMCohortTrainer", Capture)
    monkeypatch.setattr(trainer_mod.decavg.GossipEngine, "_default_node_mesh",
                        lambda self: mesh.Mesh([CPU] * 2, ("data",)))
    base = dict(topology="ring:n=4", rounds=2, eval_every=1, lr=1e-3,
                model={"kind": "lm", "nodes": 4, "batch": 2, "seq": 16})
    stores = {}
    for backend in ("sparse", "sparse_sharded"):
        spec = ExperimentSpec(**base, backend=backend)
        store = ResultsStore(str(tmp_path / f"{backend}.jsonl"))
        runner.run_spec(spec, store, verbose=True, device="cpu")
        stores[backend] = (store.curves(spec.run_id), store.finals()[spec.run_id]["final"])
    assert made[1].sharded and made[1].shards == 2
    assert "state sharded over 2 shards on cpu, cpu, 2 members a shard" in capsys.readouterr().out
    (got, final), (want, want_final) = stores["sparse_sharded"], stores["sparse"]
    assert final["fused"] is False and final["backend"] == "sparse_sharded"
    assert set(final) == set(want_final)
    assert final["consensus_mean"] == want_final["consensus_mean"]
    for a, b in zip(got, want, strict=True):
        assert {k: v for k, v in a.items() if k not in ("wall_s", "run_id")} \
            == {k: v for k, v in b.items() if k not in ("wall_s", "run_id")}
