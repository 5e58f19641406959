"""The program's spans (``repro_torch.spans``) on the CPU: off by default and
then free, nested by a stack, stamped on the profiler's clock, and laid out
in ``run_fused`` as its rounds are: one call, its staging, its rounds, each
piece's run a shard, the halo exchange a gossip round and each evaluation.
Spans on leave the trained state bit for bit as it is with them off."""

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import mesh
from repro_torch.data.loader import NodeLoader
from repro_torch.train.trainer import DecentralizedTrainer
from repro_torch.tree import tree_leaves

N, DIM = 16, 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clean():
    """Spans off and none left over, before and after each test."""
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def _trainer(backend: str, shards: int | None = None, gossip_every: int = 1):
    rng = np.random.default_rng(0)
    x = rng.random((N * 12, DIM), dtype=np.float32)
    y = rng.integers(0, 10, size=N * 12)
    parts = [np.arange(12 * i, 12 * i + 12) for i in range(N)]
    loader = NodeLoader(x, y, parts, batch_size=4, seed=1, device="cpu")
    tr = DecentralizedTrainer(f"ws:n={N},k=4,beta=0.1", loader, lr=0.05, momentum=0.9,
                              mix_impl=backend, gossip_every=gossip_every, seed=0, in_dim=DIM,
                              hidden=(6,), device="cpu")
    if shards is not None:
        tr.engine.mesh = mesh.Mesh([CPU] * shards, ("data",))
    return tr, x[:20], y[:20]


def test_off_spans_are_the_shared_null_and_record_nothing():
    assert not spans.enabled()
    a, b = spans.span("fused.call", rounds=3), spans.span("piece.replay", timed=CPU)
    assert a is b is spans._NULL
    with a:
        with b:
            pass
    assert spans.take() == []


def test_nesting_sets_parents_and_keeps_attrs():
    spans.enable()
    with spans.span("outer", round=2):
        with spans.span("inner", piece="local", shard=1):
            pass
        with spans.span("inner", piece="mix", slot=0):
            pass
    with spans.span("after"):
        pass
    spans.disable()
    with spans.span("off"):
        pass
    got = spans.take()
    assert [s.name for s in got] == ["inner", "inner", "outer", "after"]
    first, second, outer, after = got
    assert outer.parent is None and after.parent is None
    assert first.parent == second.parent == outer.id
    assert len({s.id for s in got}) == 4
    assert outer.attrs == {"round": 2} and first.attrs == {"piece": "local", "shard": 1}
    assert second.attrs == {"piece": "mix", "slot": 0}
    for s in got:
        assert s.start_ns <= s.end_ns and s.ms >= 0
    assert outer.start_ns <= first.start_ns and second.end_ns <= outer.end_ns
    assert after.start_ns >= outer.end_ns
    assert spans.take() == []


def test_stamps_share_the_profilers_clock():
    """Each span lies within 1 ms of its ``record_function`` mirror in the
    profiler's kineto events, whose stamps are epoch nanoseconds."""
    with torch.profiler.record_function("warm"):  # the op's first lookup
        pass
    spans.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for k in range(3):
            with spans.span("fused.round", round=k):
                with spans.span("piece.eager", piece="local"):
                    torch.ones(64).sum()
    got = spans.take()
    mirrors = sorted((ev for ev in prof.profiler.kineto_results.events()
                      if ev.name() in ("fused.round", "piece.eager")),
                     key=lambda ev: ev.start_ns())
    assert len(got) == len(mirrors) == 6
    for s, ev in zip(sorted(got, key=lambda s: s.start_ns), mirrors):
        assert ev.name() == s.name
        assert abs(ev.start_ns() - s.start_ns) < 1_000_000
        assert abs(ev.start_ns() + ev.duration_ns() - s.end_ns) < 1_000_000


def test_off_spans_still_label_a_profiled_call():
    """Spans off, a recording profiler still sees each span's name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with spans.span("fused.stage"):
            pass
    assert spans.take() == []
    assert any(ev.name() == "fused.stage" for ev in prof.profiler.kineto_results.events())


@pytest.mark.parametrize("backend,shards,gossip_every", [
    ("dense", None, 1), ("dense", None, 2), ("sparse_sharded", 2, 1), ("sparse_sharded", 2, 2)])
def test_run_fused_span_tree(backend, shards, gossip_every):
    """Per call: one ``fused.call`` holding its program, staging, a chunk and
    an evaluation per evaluated round, a ``fused.round`` per round and the
    close (and the gather when sharded); under each round, on the CPU, one
    eager run of each piece a shard (the local steps every round; the mix, or
    each shard's send and rows, on gossip rounds) and one halo exchange a
    sharded gossip round."""
    rounds, every, calls = 5, 2, 2
    tr, x, y = _trainer(backend, shards, gossip_every)
    spans.enable()
    for _ in range(calls):
        tr.run_fused(rounds, eval_every=every, x_test=x, y_test=y)
    got = spans.take()
    by_id = {s.id: s for s in got}

    def named(name):
        return [s for s in got if s.name == name]

    evals = len(DecentralizedTrainer._eval_rounds(rounds, every))
    gossip = sum(tr.engine.is_gossip_round(r) for r in range(rounds))
    top = named("fused.call")
    assert len(top) == calls and all(s.parent is None for s in top)
    assert all(s.attrs == {"rounds": rounds, "backend": backend} for s in top)
    want = {"fused.program": 1, "fused.stage": 1, "fused.chunk": evals, "fused.round": rounds,
            "trainer.eval": evals, "fused.close": 1, "fused.gather": int(shards is not None)}
    for name, n in want.items():
        assert len(named(name)) == calls * n, name
        assert all(by_id[s.parent].name == "fused.call" for s in named(name)), name
    assert [s.attrs["round"] for s in named("fused.round")] == list(range(rounds)) * calls
    assert all(by_id[s.parent].name == "trainer.eval" for s in named("eval.test_set"))
    assert len(named("eval.test_set")) == calls * evals

    pieces = named("piece.eager")
    assert all(by_id[s.parent].name == "fused.round" for s in pieces)
    assert not named("piece.capture") and not named("piece.replay")  # no card
    per = 1 if shards is None else shards
    mixes = ["mix"] if shards is None else ["send", "rows"]
    for piece, n in [("local", rounds)] + [(m, gossip) for m in mixes]:
        mine = [s for s in pieces if s.attrs["piece"] == piece]
        assert len(mine) == calls * n * per, piece
        if shards is not None:
            assert sorted(s.attrs["shard"] for s in mine) == sorted(
                list(range(shards)) * calls * n)
    assert len(pieces) == calls * per * (rounds + len(mixes) * gossip)
    exchanges = named("sharded.exchange")
    assert len(exchanges) == (calls * gossip if shards is not None else 0)
    assert all(by_id[s.parent].name == "fused.round" for s in exchanges)


@pytest.mark.parametrize("backend,shards", [("dense", None), ("sparse_sharded", 2)])
def test_spans_leave_the_state_bit_identical(backend, shards):
    states = []
    for on in (False, True):
        tr, x, y = _trainer(backend, shards)
        if on:
            spans.enable()
        hist = tr.run_fused(4, eval_every=2, x_test=x, y_test=y)
        spans.disable()
        assert bool(spans.take()) == on
        states.append((tree_leaves(tr.params) + tree_leaves(tr.momentum),
                       [m.per_node_acc for m in hist]))
    (a, acc_a), (b, acc_b) = states
    assert all(torch.equal(u, v) for u, v in zip(a, b, strict=True))
    assert all(np.array_equal(u, v) for u, v in zip(acc_a, acc_b, strict=True))
