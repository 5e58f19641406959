"""The port's core/faults.py against the reference's: the grammar, the
``FaultTrace`` masks and delays byte for byte, the faulted mixes within
1e-6 (with and without stale publishes), the straggler ring, the analytics,
and the engine's faulted rounds and gating."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decavg as ref_decavg
from repro.core import faults as RF
from repro.core import mixing as ref_mixing
from repro.core import sparse as ref_sparse
from repro.core import topology as ref_topology
from repro_torch.core import decavg, mesh
from repro_torch.core import faults as F
from repro_torch.core import topology
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.tree import tree_leaves

N, ROUNDS = 16, 8
SPECS = {
    "churn": "churn:p_leave=0.3,p_join=0.4",
    "hubs": "churn:p_leave=1.0,p_join=0.0,frac=0.25,start=3@targeted=hubs",
    "straggler": "straggler:frac=0.3,delay=3;straggler:frac=0.1,delay=1@targeted=leaves",
    "drop": "drop:p_edge=0.3",
    "combined": "churn:p_leave=0.15,p_join=0.5;straggler:frac=0.3,delay=3;drop:p_edge=0.2",
}
TOPOLOGIES = ("ba:n=16,m=2", "ba:n=16,m=2@rewire=3")


def _traces(spec, topo, seed=0):
    return (RF.FaultTrace(spec, ref_topology.make_schedule(topo, seed=seed), seed=seed),
            F.FaultTrace(spec, topology.make_schedule(topo, seed=seed), seed=seed))


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_trace_masks_byte_for_byte(name, topo):
    ref, port = _traces(SPECS[name], topo)
    assert port.delay.dtype == ref.delay.dtype and port.delay.tobytes() == ref.delay.tobytes()
    assert port.delay_max == ref.delay_max
    assert port.alive_matrix(ROUNDS).tobytes() == ref.alive_matrix(ROUNDS).tobytes()
    sched = ref_topology.make_schedule(topo, seed=0)
    for r in range(ROUNDS):
        assert port.dense_keep(r).tobytes() == ref.dense_keep(r).tobytes()
        csr = ref_sparse.csr_from_graph(sched.graph_at(r))
        rows, cols, vals = (np.asarray(a) for a in (csr.rows, csr.indices, csr.values))
        vals = np.where(np.arange(vals.size) % 7 == 0, 0.0, vals)  # a few padding slots
        assert (port.entry_keep(r, rows, cols, vals).tobytes()
                == ref.entry_keep(r, rows, cols, vals).tobytes())
        i, j = np.nonzero(np.triu(sched.graph_at(r).adj, 1))
        assert ([port.edge_kept(r, a, b) for a, b in zip(i, j)]
                == [ref.edge_kept(r, a, b) for a, b in zip(i, j)])


def test_trace_is_incremental():
    """Drawn round by round or all at once, the masks are the same."""
    a, b = _traces(SPECS["combined"], TOPOLOGIES[0])[1], _traces(SPECS["combined"], TOPOLOGIES[0])[1]
    for r in range(ROUNDS):
        a.alive(r)
    assert a.alive_matrix(ROUNDS).tobytes() == b.alive_matrix(ROUNDS).tobytes()


@pytest.mark.parametrize("spec", [
    "churn", "churn:p_leave=0.4,start=8@targeted=hubs", SPECS["combined"], SPECS["straggler"]])
def test_grammar_matches_reference(spec):
    got, want = F.parse_faults(spec), RF.parse_faults(spec)
    assert [(c.kind, dict(c.params), c.target) for c in got] == [
        (c.kind, dict(c.params), c.target) for c in want]
    sch, ref = F.FaultSchedule.parse(spec), RF.FaultSchedule.parse(spec)
    assert (sch.has_churn, sch.has_drop, sch.has_stragglers, sch.max_delay) == (
        ref.has_churn, ref.has_drop, ref.has_stragglers, ref.max_delay)
    assert F.FaultSchedule.parse(sch) is sch


@pytest.mark.parametrize("bad", [
    "", " ; ", "meteor:p=0.1", "churn:p_leave=1.5", "churn:bogus=1",
    "churn@targeted=mediums", "churn@flavor=hubs", "straggler:delay=0",
    "drop:p_edge=0.1@targeted=hubs",
])
def test_grammar_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError) as ref_err:
        RF.parse_faults(bad)
    with pytest.raises(ValueError) as err:
        F.parse_faults(bad)
    assert str(err.value) == str(ref_err.value)


def test_spec_parses_faults_eagerly():
    with pytest.raises(ValueError, match="unknown fault kind"):
        ExperimentSpec(topology="ring:n=16", faults="meteor:p=1")
    assert ExperimentSpec(topology="ring:n=16", faults="drop:p_edge=0.1").faults


def _mixing_case(r=4, spec=SPECS["combined"], seed=0):
    """Round ``r`` of the combined trace over a decavg W with unequal data
    sizes, a params tree and a stale-publish tree."""
    trace = _traces(spec, TOPOLOGIES[0])[1]
    g = ref_topology.make_schedule(TOPOLOGIES[0], seed=0).graph_at(0)
    sizes = np.random.default_rng(seed).integers(5, 50, N).astype(np.float64)
    w = np.asarray(ref_mixing.decavg_matrix(g, sizes), np.float32)
    rng = np.random.default_rng(seed + 1)
    params = {"a": rng.standard_normal((N, 5, 3)).astype(np.float32),
              "b": rng.standard_normal((N, 7)).astype(np.float32)}
    pub = {k: v + rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    return trace, w, params, pub, r


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _assert_tree(got, want, atol=1e-6):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol)


@pytest.mark.parametrize("stale", [False, True])
def test_mix_faulted_dense_matches_reference(stale):
    trace, w, params, pub, r = _mixing_case()
    keep, alive = trace.dense_keep(r), trace.alive(r)
    assert not alive.all() and not keep[alive][:, alive].all()
    want = RF.mix_faulted_dense(jnp.asarray(w), jnp.asarray(keep), jnp.asarray(alive),
                                _j(params), _j(pub) if stale else None)
    got = F.mix_faulted_dense(torch.as_tensor(w), torch.as_tensor(keep), torch.as_tensor(alive),
                              _t(params), _t(pub) if stale else None)
    _assert_tree(got, want)
    for k in params:  # dead destination rows pass through to the bit
        assert np.array_equal(got[k].numpy()[~alive], params[k][~alive])


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("layout", ["csr", "ell"])
def test_mix_faulted_sparse_matches_reference(stale, layout):
    trace, w, params, pub, r = _mixing_case()
    csr = ref_sparse.csr_from_dense(w)
    rows, cols, vals = (np.array(a) for a in (csr.rows, csr.indices, csr.values))
    keep, alive = trace.entry_keep(r, rows, cols, vals), trace.alive(r)
    want = RF.mix_faulted_csr(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                              jnp.asarray(keep), jnp.asarray(alive), N, _j(params),
                              _j(pub) if stale else None)
    if layout == "csr":
        got = F.mix_faulted_csr(torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(vals),
                                torch.as_tensor(keep), torch.as_tensor(alive), N, _t(params),
                                _t(pub) if stale else None)
    else:
        from repro_torch.core import sparse

        idx, val = sparse.ell_from_csr(sparse.csr_from_dense(w))
        ekeep = trace.entry_keep(r, np.broadcast_to(np.arange(N)[:, None], idx.shape), idx, val)
        got = F.mix_faulted_ell(torch.as_tensor(idx, dtype=torch.int64), torch.as_tensor(val),
                                torch.as_tensor(ekeep), torch.as_tensor(alive), _t(params),
                                _t(pub) if stale else None)
    _assert_tree(got, want)


def test_renorm_and_effective_w_match_reference():
    trace, w, _, _, r = _mixing_case()
    keep, alive = trace.dense_keep(r), trace.alive(r)
    keep[3] = False  # a row that loses all its mass
    wn, ok = F.renorm_dense(torch.as_tensor(w), torch.as_tensor(keep))
    rwn, rok = RF.renorm_dense(jnp.asarray(w), jnp.asarray(keep))
    np.testing.assert_allclose(wn.numpy(), np.asarray(rwn), rtol=0, atol=1e-6)
    assert np.array_equal(ok.numpy(), np.asarray(rok)) and not ok[3]
    np.testing.assert_allclose(F.faulted_dense_w(w, keep, alive),
                               RF.faulted_dense_w(w, keep, alive), rtol=0, atol=1e-6)
    csr = ref_sparse.csr_from_dense(w)
    rows, vals = np.array(csr.rows), np.array(csr.values)
    ekeep = trace.entry_keep(r, rows, np.array(csr.indices))
    vn, vok = F.renorm_values(torch.as_tensor(vals), torch.as_tensor(ekeep), torch.as_tensor(rows), N)
    rvn, rvok = RF.renorm_values(jnp.asarray(vals), jnp.asarray(ekeep), jnp.asarray(rows), N)
    np.testing.assert_allclose(vn.numpy(), np.asarray(rvn), rtol=0, atol=1e-6)
    assert np.array_equal(vok.numpy(), np.asarray(rvok))


def test_ring_buffer_matches_reference():
    trace = _traces(SPECS["straggler"], TOPOLOGIES[0])[1]
    delay = trace.delay
    assert delay.max() == 3 and (delay == 1).any()
    rng = np.random.default_rng(0)
    hist = F.init_history(_t({"a": np.zeros((N, 4), np.float32)}), trace.delay_max + 1)
    ref_hist = RF.init_history(_j({"a": np.zeros((N, 4), np.float32)}), trace.delay_max + 1)
    for r in range(7):
        p = {"a": rng.standard_normal((N, 4)).astype(np.float32)}
        # Half the rounds take the round as a device tensor, as the fused path does.
        rr = torch.tensor(r) if r % 2 else r
        pub, hist = F.push_and_publish(_t(p), hist, rr, torch.as_tensor(delay))
        ref_pub, ref_hist = RF.push_and_publish(_j(p), ref_hist, jnp.int32(r), jnp.asarray(delay))
        assert np.array_equal(pub["a"].numpy(), np.asarray(ref_pub["a"]))
        assert np.array_equal(hist["a"].numpy(), np.asarray(ref_hist["a"]))


def test_where_alive_and_stacked():
    alive = np.array([True, False, True])
    new = {"w": torch.ones(3, 2), "count": torch.tensor(5.0)}
    old = {"w": torch.zeros(3, 2), "count": torch.tensor(4.0)}
    got = F.where_alive_stacked(torch.as_tensor(alive), new, old)
    assert got["w"][:, 0].tolist() == [1.0, 0.0, 1.0] and float(got["count"]) == 5.0
    got = F.where_alive(torch.as_tensor(alive), {"w": new["w"]}, {"w": old["w"]})
    assert got["w"].sum(dim=1).tolist() == [2.0, 0.0, 2.0]


@pytest.mark.parametrize("counts,curve,event", [
    ([16, 16, 12, 12, 10, 13], [(0, 0.1), (2, 0.3), (4, 0.2), (5, 0.35)], 2),
    ([8, 8, 8], [(0, 0.5), (2, 0.4)], 1),
    ([8, 6, 6], [(1, 0.5), (2, 0.4)], 1),
])
def test_analytics_match_reference(counts, curve, event):
    n = max(counts)
    assert F.churn_rounds(counts, n) == RF.churn_rounds(counts, n)
    rounds, accs = [r for r, _ in curve], [a for _, a in curve]
    assert F.recovery_rounds(rounds, accs, event) == RF.recovery_rounds(rounds, accs, event)


@pytest.mark.parametrize("backend", ["dense", "sparse"])
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_engine_faulted_rounds_match_reference(backend, topo):
    """The engine's own loop rounds (ring buffer pushed before the cadence
    gate, gossip every 2nd round) over 8 rounds."""
    kw = dict(backend=backend, faults=SPECS["combined"], gossip_every=2, seed=0)
    ref = ref_decavg.GossipEngine(topo, **kw)
    eng = decavg.GossipEngine(topo, device="cpu", **kw)
    rng = np.random.default_rng(3)
    p = rng.standard_normal((N, 6)).astype(np.float32)
    want, got = jnp.asarray(p), torch.as_tensor(p)
    for r in range(ROUNDS):
        step = rng.standard_normal((N, 6)).astype(np.float32) * 0.1
        want = ref.mix(want + step, round=r)
        got = eng.mix(got + torch.as_tensor(step), round=r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_engine_gating():
    caps = decavg.GossipEngine.capabilities()
    faulted = {b for b, c in caps.items() if c["faults"]}
    assert faulted == {"dense", "sparse", "sparse_sharded"}
    assert faulted == {b for b, c in ref_decavg.GossipEngine.capabilities().items() if c["faults"]}
    sixteen = mesh.Mesh([torch.device("cpu")] * 16, ("data",))
    for backend in ("pallas", "sparse_pallas", "sharded", "permute"):
        with pytest.raises(ValueError, match="does not support faults"):
            decavg.GossipEngine("ring:n=16", backend=backend, faults="drop:p_edge=0.1",
                                mesh=sixteen, device="cpu")
    eng = decavg.GossipEngine("ring:n=16", faults="drop:p_edge=0.1", device="cpu")
    with pytest.raises(ValueError, match="round="):
        eng.mix(torch.zeros(16, 3))
    with pytest.raises(ValueError, match="does not support faults"):
        eng.mix(torch.zeros(16, 3), round=0, backend="pallas")
    with pytest.raises(ValueError, match="no fault schedule"):
        decavg.GossipEngine("ring:n=16", device="cpu").fault_trace
    with pytest.raises(ValueError, match="sparse_p_chunk"):
        decavg.GossipEngine("ring:n=16", backend="sparse", sparse_p_chunk=8,
                            faults="drop:p_edge=0.1", device="cpu")


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_program_stages_masks_in_its_layout(backend):
    eng = decavg.GossipEngine("ba:n=16,m=2@rewire=3", backend=backend,
                              faults=SPECS["combined"], device="cpu")
    prog = eng.program(ROUNDS)
    trace = eng.fault_trace
    assert prog.faulted and prog.delay_max == trace.delay_max
    assert prog.f_alive.numpy().tobytes() == trace.alive_matrix(ROUNDS).tobytes()
    assert prog.f_delay.numpy().tobytes() == trace.delay.tobytes()
    if backend == "dense":
        assert tuple(prog.f_keep.shape) == (ROUNDS, N, N)
    else:
        assert tuple(prog.f_keep.shape) == (ROUNDS,) + tuple(prog.ell_idx.shape[1:])
        pad = prog.ell_val[prog.period_idx] == 0
        assert pad.any() and prog.f_keep[pad].all()  # padding slots kept, weigh 0
    p = torch.randn(N, 4, generator=torch.Generator().manual_seed(0))
    for r in range(ROUNDS):
        eng.refresh(r)
        want = eng.mix_faulted(p, r, p)
        got = prog.apply(p, r)  # pub defaults to params
        got_t = prog.apply_period(p, int(prog.period_idx[r]), r=torch.tensor(r))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert torch.equal(got, got_t)
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves([prog.f_alive, prog.f_keep]))
