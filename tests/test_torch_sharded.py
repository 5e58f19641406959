"""The port's node-sharded backends (``sharded``, ``sparse_sharded``,
``permute``) against the JAX reference, on the same numpy inputs.

The sharded CSR layouts equal the reference's byte for byte; the mixes run
over ``core.mesh.Mesh`` meshes that repeat the CPU (``Mesh([cpu] * 8)``, the
counterpart of the reference's 8 fake CPU devices) and are held to the
reference's ``mix_sparse``/``mix_dense`` and, for ``sparse_sharded``, to
the port's ``sparse`` backend to the bit. One subprocess test holds the
mixing functions to the reference's own ``mix_sharded``,
``mix_sharded_sparse`` and ``mix_permute`` on 8 fake CPU devices.
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decavg as ref_decavg
from repro.core import mixing as ref_mixing
from repro.core import sparse as ref_sparse
from repro.core import topology as ref_topology
from repro_torch.core import decavg, mesh, mixing, sparse, topology
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)  # many small operations: threads only add overhead

CPU = torch.device("cpu")
SPECS = ["ws:n=48,k=4,beta=0.2", "ba:n=48,m=2", "caveman:cliques=6,size=8"]
REWIRE = "ws:n=48,k=4,beta=0.2@rewire=2"
SHARDS = [1, 2, 4, 8]


def _mesh(shards: int, axis: str = "data") -> mesh.Mesh:
    return mesh.Mesh([CPU] * shards, (axis,))


def _params(n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 9, 3)).astype(np.float32),
            "b": {"w": rng.normal(size=(n, 41)).astype(np.float32)}}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def _csr_pair(spec: str, seed: int = 2):
    n = topology.make(spec, seed=seed).num_nodes
    sizes = np.arange(1, n + 1, dtype=np.float64)
    port = sparse.csr_from_graph(topology.make(spec, seed=seed), sizes)
    ref = ref_sparse.csr_from_graph(ref_topology.make(spec, seed=seed), sizes)
    return port, ref


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _close_to_ref(port, ref, atol):
    for g, w in zip(tree_leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)


# -- layouts, byte for byte ------------------------------------------------------


def _assert_arrays_equal(got, want, name):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("spec", SPECS)
def test_shard_csr_equals_reference(spec, shards):
    port_csr, ref_csr = _csr_pair(spec)
    got, want = sparse.shard_csr(port_csr, shards), ref_sparse.shard_csr(ref_csr, shards)
    for name in ("halo", "rows", "cols", "values", "local_src", "local_dst"):
        _assert_arrays_equal(getattr(got, name), getattr(want, name), name)
    assert len(got.ring_send) == len(want.ring_send) == shards - 1
    for d, (s, r) in enumerate(zip(got.ring_send, got.ring_recv)):
        _assert_arrays_equal(s, want.ring_send[d], f"ring_send[{d}]")
        _assert_arrays_equal(r, want.ring_recv[d], f"ring_recv[{d}]")
    assert (got.shape, got.shards, got.rows_per_shard) == (
        tuple(want.shape), want.shards, want.rows_per_shard)
    assert (got.halo_width, got.ring_width, got.nbytes) == (
        want.halo_width, want.ring_width, want.nbytes)
    for p in (1, 41, 50890):
        assert sparse.halo_wire_bytes(got, p) == ref_sparse.halo_wire_bytes(want, p)


@pytest.mark.parametrize("shards", SHARDS)
def test_stack_shard_csr_equals_reference(shards):
    """A @rewire schedule's periods, padded and stacked as the reference's
    fused program stacks them."""
    port_sched = topology.make_schedule(REWIRE, seed=1)
    ref_sched = ref_topology.make_schedule(REWIRE, seed=1)
    rounds = range(0, 8, 2)
    got = sparse.stack_shard_csr([
        sparse.shard_csr(sparse.csr_from_graph(port_sched.graph_at(r)), shards) for r in rounds])
    want = ref_sparse.stack_shard_csr([
        ref_sparse.shard_csr(ref_sparse.csr_from_graph(ref_sched.graph_at(r)), shards)
        for r in rounds])
    assert set(got) == set(want)
    for name in ("halo", "rows", "cols", "values", "local_src", "local_dst"):
        _assert_arrays_equal(got[name], want[name], name)
    for name in ("ring_send", "ring_recv"):
        assert len(got[name]) == len(want[name]) == shards - 1
        for d, (a, b) in enumerate(zip(got[name], want[name])):
            _assert_arrays_equal(a, b, f"{name}[{d}]")


def test_layout_errors_match_reference():
    port_csr, ref_csr = _csr_pair(SPECS[0])
    for shards in (5, 0):
        with pytest.raises(ValueError, match="not divisible"):
            sparse.shard_csr(port_csr, shards)
        with pytest.raises(ValueError, match="not divisible"):
            ref_sparse.shard_csr(ref_csr, shards)
    with pytest.raises(ValueError, match="share shape and shard count"):
        sparse.stack_shard_csr([sparse.shard_csr(port_csr, 2), sparse.shard_csr(port_csr, 4)])


@pytest.mark.parametrize("shards", [1, 4])
def test_shard_ell_is_the_global_ell_sliced(shards):
    """Each shard's ELL rows are the global ELL's rows, columns through the
    halo, in CSR order; its widths are the shard's longest row."""
    csr, _ = _csr_pair(SPECS[1])
    sh = sparse.shard_csr(csr, shards)
    idx, val, pos, widths = sparse.shard_ell(sh.rows, sh.cols, sh.values, sh.rows_per_shard)
    g_idx, g_val = sparse.ell_from_csr(csr)
    blk = sh.rows_per_shard
    counts = np.diff(csr.indptr)
    for s in range(shards):
        k = widths[s]
        assert k == counts[s * blk:(s + 1) * blk].max()
        np.testing.assert_array_equal(val[s, :, :k], g_val[s * blk:(s + 1) * blk, :k])
        real = val[s, :, :k] != 0
        np.testing.assert_array_equal(sh.halo[s][idx[s, :, :k]][real],
                                      g_idx[s * blk:(s + 1) * blk, :k][real])
        np.testing.assert_array_equal(sh.values[s][pos[s, :, :k]][real], val[s, :, :k][real])
        assert not val[s, :, k:].any()


# -- the mesh ------------------------------------------------------------------------


def test_mesh_shape_axes_and_collectives():
    m = mesh.Mesh(np.array([[CPU] * 2] * 4, dtype=object), ("data", "model"))
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert mesh.axis_size(m, ("data", "model")) == 8 and mesh.axis_size(m, "data") == 4
    assert mesh.axis_index(m, ("data", "model"), {"data": 3, "model": 1}) == 7
    assert mesh.axis_index(m, ("model", "data"), {"data": 3, "model": 1}) == 7
    assert mesh.axis_index(m, ("model", "data"), {"data": 1, "model": 1}) == 5
    assert m.shard_devices("data") == [CPU] * 4
    with pytest.raises(ValueError, match="axis names"):
        mesh.Mesh([CPU] * 4, ("data", "model"))
    slabs = [torch.full((2, 3), float(i)) for i in range(4)]
    full = mesh.all_gather(slabs, CPU)
    assert torch.equal(full, torch.cat(slabs))
    parts = [torch.arange(8.0)[:, None] * (i + 1) for i in range(4)]
    got = mesh.psum_scatter(parts, [CPU] * 4)
    assert torch.equal(torch.cat(got), torch.arange(8.0)[:, None] * 10)
    moved = mesh.ppermute(slabs, [(0, 1), (1, 0), (3, 2)], [CPU] * 4)
    assert torch.equal(moved[0], slabs[1]) and torch.equal(moved[2], slabs[3])
    assert torch.equal(moved[3], torch.zeros(2, 3))  # receives nothing: zeros


def test_local_mesh_follows_the_device():
    assert mesh.local_mesh(device="cpu").shape == {"data": 1}
    assert mesh.local_mesh("nodes", device="cpu", shards=8).shape == {"nodes": 8}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.local_mesh()
    assert mesh.same_device("cpu", CPU)
    assert not mesh.same_device(torch.device("cuda", 0), torch.device("cuda", 1))


# -- mixes -------------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_sparse_sharded_is_sparse_to_the_bit(spec):
    """Every S, both halo schedules, with and without p_chunk: the port's
    sparse bits; within 1e-6 of the reference's mix_sparse."""
    port_csr, ref_csr = _csr_pair(spec)
    p = _params(port_csr.shape[0], seed=3)
    want = sparse.mix_sparse(port_csr, _torch(p))
    ref = ref_sparse.mix_sparse(ref_csr, jax.tree.map(jnp.asarray, p))
    _close_to_ref(want, ref, 1e-6)
    for shards in SHARDS:
        sh = sparse.shard_csr(port_csr, shards)
        for halo in ("allgather", "ring", "auto"):
            for p_chunk in (None, 7):
                got = decavg.mix_sharded_sparse(sh, _torch(p), mesh=_mesh(shards),
                                                halo_schedule=halo, p_chunk=p_chunk)
                assert _same(got, want), (shards, halo, p_chunk)
    with pytest.raises(ValueError, match="built for 2 shards"):
        decavg.mix_sharded_sparse(sparse.shard_csr(port_csr, 2), _torch(p), mesh=_mesh(4))
    with pytest.raises(ValueError, match="halo_schedule"):
        decavg.mix_sharded_sparse(sparse.shard_csr(port_csr, 2), _torch(p), mesh=_mesh(2),
                                  halo_schedule="tree")


@pytest.mark.parametrize("shards", [1, 8])
def test_engine_sparse_sharded_follows_a_rewire_schedule(shards):
    """Through the engine, round by round over a @rewire schedule: the
    per-period layout is rebuilt and every round is sparse's to the bit and
    within 1e-6 of the reference's dense engine."""
    p = _torch(_params(48, seed=4))
    ref = ref_decavg.GossipEngine(REWIRE, backend="dense", seed=1)
    want_eng = decavg.GossipEngine(REWIRE, backend="sparse", seed=1, device="cpu")
    for halo in ("allgather", "ring"):
        eng = decavg.GossipEngine(REWIRE, backend="sparse_sharded", mesh=_mesh(shards),
                                  halo_schedule=halo, seed=1, device="cpu")
        for r in range(6):
            got = eng.mix(p, round=r)
            assert _same(got, want_eng.mix(p, round=r))
            want = ref.mix(jax.tree.map(lambda t: jnp.asarray(t.numpy()), p), round=r)
            _close_to_ref(got, want, 1e-6)
        assert eng.sharded_csr().shards == shards


@pytest.mark.parametrize("faults", ["churn:p_leave=0.3,p_join=0.2;drop:p_edge=0.2",
                                    "straggler:frac=0.3,delay=2;drop:p_edge=0.1"])
@pytest.mark.parametrize("shards", [1, 8])
def test_engine_faulted_sparse_sharded_is_sparse_to_the_bit(faults, shards):
    """The engine's faulted loop rounds (straggler ring, cadence) on 8
    shards give the sparse backend's bits, and stay within 1e-6 of the
    reference's faulted sparse_sharded engine on its 1-device mesh."""
    kw = dict(faults=faults, gossip_every=2, seed=0)
    spec = SPECS[1]
    ref = ref_decavg.GossipEngine(spec, backend="sparse_sharded", **kw)
    want_eng = decavg.GossipEngine(spec, backend="sparse", device="cpu", **kw)
    eng = decavg.GossipEngine(spec, backend="sparse_sharded", mesh=_mesh(shards),
                              halo_schedule="ring", device="cpu", **kw)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((48, 6)).astype(np.float32)
    got, want, ref_x = torch.as_tensor(x), torch.as_tensor(x), jnp.asarray(x)
    for r in range(6):
        step = rng.standard_normal((48, 6)).astype(np.float32) * 0.1
        got = eng.mix(got + torch.as_tensor(step), round=r)
        want = want_eng.mix(want + torch.as_tensor(step), round=r)
        ref_x = ref.mix(ref_x + step, round=r)
        assert torch.equal(got, want), r
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_x), rtol=0, atol=1e-6)


def test_sharded_keep_is_the_references():
    kw = dict(backend="sparse_sharded", faults="churn:p_leave=0.3;drop:p_edge=0.3", seed=0)
    eng = decavg.GossipEngine("ba:n=48,m=2", device="cpu", **kw)
    eng.mesh = _mesh(4)
    ref = ref_decavg.GossipEngine("ba:n=48,m=2", **kw)
    shcsr = ref_sparse.shard_csr(ref.csr, 4)
    blk = shcsr.rows_per_shard
    rows_g = np.asarray(shcsr.rows) + np.arange(4)[:, None] * blk
    cols_g = np.take_along_axis(np.asarray(shcsr.halo), np.asarray(shcsr.cols), axis=1)
    for r in range(4):
        want = ref.fault_trace.entry_keep(r, rows_g, cols_g, np.asarray(shcsr.values))
        np.testing.assert_array_equal(eng.sharded_keep(r), want)


@pytest.mark.parametrize("node_axis,shards", [(("data", "model"), 8), ("data", 4)])
@pytest.mark.parametrize("schedule", ["allgather", "reduce_scatter"])
def test_sharded_on_a_4x2_mesh(node_axis, shards, schedule):
    """The dense sharded backend on the reference's (4, 2) mesh, the node
    axis over both axes (8 shards) or over "data" (4 shards, replicated over
    "model"): within 1e-5 of the reference's mix_dense."""
    g = topology.make("er:n=16,p=0.4", seed=0)
    w = mixing.decavg_matrix(g, np.ones(16))
    p = {"a": np.random.default_rng(0).normal(size=(16, 33, 2)).astype(np.float32)}
    m = mesh.Mesh(np.array([[CPU] * 2] * 4, dtype=object), ("data", "model"))
    assert len(m.shard_devices(node_axis)) == shards
    got = decavg.mix_sharded(torch.as_tensor(w, dtype=torch.float32), _torch(p), mesh=m,
                             node_axis=node_axis, schedule=schedule)
    want = ref_decavg.mix_dense(jnp.asarray(w, jnp.float32), jax.tree.map(jnp.asarray, p))
    _close_to_ref(got, want, 1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        decavg.mix_sharded(torch.eye(12), {"a": torch.zeros(12, 2)}, mesh=m,
                           node_axis=("data", "model"))


def test_sharded_engine_matches_reference_dense():
    p = _torch(_params(48, seed=6))
    want = ref_decavg.GossipEngine(SPECS[0], backend="dense", seed=0).mix(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), p))
    for schedule in ("allgather", "reduce_scatter"):
        eng = decavg.GossipEngine(SPECS[0], backend="sharded", mesh=_mesh(8),
                                  sharded_schedule=schedule, seed=0, device="cpu")
        _close_to_ref(eng.mix(p), want, 1e-5)


def test_permute_recolors_per_period(monkeypatch):
    """permute over a 16-shard mesh (one node a shard) on a @rewire ring:
    one coloring per period, reused within it, every round within 1e-5 of
    the reference's dense engine."""
    calls = []
    orig = mixing.edge_coloring
    monkeypatch.setattr(mixing, "edge_coloring", lambda g: (calls.append(1), orig(g))[1])
    spec = "ws:n=16,k=4,beta=0.3@rewire=2"
    eng = decavg.GossipEngine(spec, backend="permute", mesh=_mesh(16), seed=3, device="cpu")
    ref = ref_decavg.GossipEngine(spec, backend="dense", seed=3)
    p = _torch(_params(16, seed=7))
    for r in range(6):
        got = eng.mix(p, round=r)
        want = ref.mix(jax.tree.map(lambda t: jnp.asarray(t.numpy()), p), round=r)
        _close_to_ref(got, want, 1e-5)
    assert len(calls) == 3  # periods 0, 1, 2
    assert not eng.refresh(5) and eng.refresh(0) and len(calls) == 3  # cached on revisit
    assert eng._colors == ref_mixing.edge_coloring(ref_topology.make_schedule(spec, seed=3)
                                                   .graph_at(0))
    with pytest.raises(ValueError, match="mix_permute needs num_nodes"):
        decavg.mix_permute(torch.eye(16), p, eng._colors, mesh=_mesh(8))


# -- the reference's own sharded mixes, on 8 fake CPU devices --------------------


def test_mixing_functions_match_reference_on_8_fake_devices():
    """The reference's mix_sharded_sparse (both halo schedules, p_chunk),
    mix_sharded (both schedules) and mix_permute under shard_map on 8 fake
    CPU devices, against the port's functions on Mesh([cpu] * 8): 1e-6 for
    the sparse mixes, 1e-5 for the dense ones."""
    code = textwrap.dedent(
        """
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import numpy as np, jax, jax.numpy as jnp, torch
        from repro.core import decavg as RD, mixing as RM, sparse as RS, topology as RT
        from repro_torch.core import decavg as D, mesh as M, sparse as S, topology as T
        from repro_torch.tree import tree_leaves
        assert jax.device_count() == 8
        jm = jax.sharding.Mesh(np.asarray(jax.devices()), ("nodes",))
        tm = M.Mesh([torch.device("cpu")] * 8, ("nodes",))

        def check(got, want, atol, what):
            err = max(float(np.abs(g.numpy() - np.asarray(w)).max())
                      for g, w in zip(tree_leaves(got), jax.tree.leaves(want)))
            assert err <= atol, (what, err)

        rng = np.random.default_rng(0)
        for spec in ("ws:n=24,k=4,beta=0.2", "ba:n=24,m=2", "caveman:cliques=3,size=8"):
            n = 24
            sizes = np.arange(1, n + 1, dtype=np.float64)
            rcsr = RS.csr_from_graph(RT.make(spec, seed=2), sizes)
            tcsr = S.csr_from_graph(T.make(spec, seed=2), sizes)
            p = {"a": rng.normal(size=(n, 9, 3)).astype(np.float32),
                 "b": rng.normal(size=(n, 131)).astype(np.float32)}
            jp = jax.tree.map(jnp.asarray, p)
            tp = {k: torch.as_tensor(v) for k, v in p.items()}
            for sched in ("allgather", "ring", "auto"):
                for chunk in (None, 32):
                    want = RD.mix_sharded_sparse(RS.shard_csr(rcsr, 8), jp, mesh=jm,
                                                 node_axis="nodes", p_chunk=chunk,
                                                 halo_schedule=sched)
                    got = D.mix_sharded_sparse(S.shard_csr(tcsr, 8), tp, mesh=tm,
                                               node_axis="nodes", p_chunk=chunk,
                                               halo_schedule=sched)
                    check(got, want, 1e-6, (spec, sched, chunk))
            w = jnp.asarray(RS.csr_to_dense(rcsr), jnp.float32)
            for sched in ("allgather", "reduce_scatter"):
                want = RD.mix_sharded(w, jp, mesh=jm, node_axis="nodes", schedule=sched)
                got = D.mix_sharded(torch.as_tensor(np.asarray(w)), tp, mesh=tm,
                                    node_axis="nodes", schedule=sched)
                check(got, want, 1e-5, (spec, sched))
        g = RT.make("ring:n=8", seed=0)
        w = jnp.asarray(RM.decavg_matrix(g, np.ones(8)), jnp.float32)
        colors = RM.edge_coloring(g)
        p = {"a": rng.normal(size=(8, 5, 3)).astype(np.float32)}
        want = RD.mix_permute(w, jax.tree.map(jnp.asarray, p), colors, mesh=jm,
                              node_axis="nodes")
        got = D.mix_permute(torch.as_tensor(np.asarray(w)), {"a": torch.as_tensor(p["a"])},
                            colors, mesh=tm, node_axis="nodes")
        check(got, want, 1e-5, "permute")
        print("OK")
        """
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout
