"""The port's sparse path against the JAX reference, on the same numpy inputs:
the CSR, ELL and blocked-ELL builders (the same arrays, byte for byte), the
plain versions of both sparse kernels against the Pallas kernels in
interpret mode, ``mix_sparse`` and ``mix_sparse_pallas``, the engine's sparse
backends and its ``MixingProgram`` staging.

On CPU tensors the kernel wrappers take their plain versions; the CUDA
kernels themselves are held to those by tests/test_torch_cuda.py on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decavg as ref_decavg
from repro.core import mixing as ref_mixing
from repro.core import sparse as ref_sparse
from repro.core import topology as ref_topology
from repro.kernels import ops as ref_ops
from repro.train import trainer as ref_trainer
from repro_torch.convert import params_from_numpy
from repro_torch.core import decavg, sparse
from repro_torch.core import topology
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels import sparse_gossip as sg
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves

SPECS = [  # tests/test_sparse.py's
    "er:n=40,p=0.2",
    "ba:n=40,m=3",
    "sbm:sizes=10+10+10+10,p_in=0.6,p_out=0.05",
    "ring:n=40",
    "ws:n=40,k=4,beta=0.2",
]


def _tol(dtype):
    # bf16 keeps 8 bits of mantissa; f32 sums of a few dozen terms stay near 1e-6.
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bf16" else dict(rtol=3e-5, atol=3e-5)


def _params(n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 13, 2)).astype(np.float32),
            "b": {"w": rng.normal(size=(n, 41)).astype(np.float32)}}


def _assert_trees_close(port, ref, **tol):
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    port_leaves = tree_leaves(port)
    assert len(port_leaves) == len(ref_leaves)
    for g, w in zip(port_leaves, ref_leaves):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32), **tol)


def _csr_pair(spec: str, kind: str = "decavg", seed: int = 3):
    sizes = np.random.default_rng(7).uniform(0.5, 5.0, size=40)
    port = sparse.csr_from_graph(topology.make(spec, seed=seed), sizes, matrix=kind)
    ref = ref_sparse.csr_from_graph(ref_topology.make(spec, seed=seed), sizes, matrix=kind)
    return port, ref


def _assert_csr_equal(port, ref):
    assert port.shape == tuple(ref.shape)
    for name in ("indptr", "indices", "rows", "values"):
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# -- layouts -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["decavg", "uniform", "mh"])
@pytest.mark.parametrize("spec", SPECS)
def test_csr_from_graph_equals_reference(spec, kind):
    port, ref = _csr_pair(spec, kind)
    _assert_csr_equal(port, ref)
    assert port.nnz == ref.nnz and port.max_row_nnz == ref.max_row_nnz
    assert port.nbytes == ref.nbytes
    np.testing.assert_array_equal(sparse.csr_to_dense(port), ref_sparse.csr_to_dense(ref))


@pytest.mark.parametrize("spec", SPECS)
def test_csr_from_dense_equals_reference(spec):
    g = ref_topology.make(spec, seed=1)
    w = ref_mixing.decavg_matrix(g, np.arange(1, 41, dtype=np.float64))
    _assert_csr_equal(sparse.csr_from_dense(w), ref_sparse.csr_from_dense(w))
    _assert_csr_equal(sparse.csr_from_dense(torch.as_tensor(w, dtype=torch.float32)),
                      ref_sparse.csr_from_dense(w))


@pytest.mark.parametrize("spec", SPECS + ["star:n=10", "ring:n=37"])
def test_ell_and_block_ell_equal_reference(spec):
    port = sparse.csr_from_graph(topology.make(spec, seed=3))
    ref = ref_sparse.csr_from_graph(ref_topology.make(spec, seed=3))
    for got, want in zip(sparse.ell_from_csr(port), ref_sparse.ell_from_csr(ref)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got, want = sparse.block_ell_from_csr(port), ref_sparse.block_ell_from_csr(ref)
    assert (got.n, got.block, got.num_blocks, got.max_blocks_per_row) == (
        want.n, want.block, want.num_blocks, want.max_blocks_per_row)
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.val, want.val)


def test_stack_block_ell_equals_reference():
    specs = [f"er:n=24,p={p}" for p in (0.15, 0.5, 0.08)]  # unequal KB per period
    port = [sparse.csr_from_graph(topology.make(s, seed=i)) for i, s in enumerate(specs)]
    ref = [ref_sparse.csr_from_graph(ref_topology.make(s, seed=i)) for i, s in enumerate(specs)]
    for got, want in zip(sparse.stack_block_ell(port), ref_sparse.stack_block_ell(ref)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="share"):
        sparse.stack_block_ell([port[0], sparse.csr_from_graph(topology.make("ring:n=8"))])


def test_csr_builder_rejects_bad_args():
    g = topology.make("ring:n=8")
    with pytest.raises(ValueError, match="matrix"):
        sparse.csr_from_graph(g, matrix="nope")
    with pytest.raises(ValueError, match="data_sizes"):
        sparse.csr_from_graph(g, np.ones(5))


def test_auto_p_chunk_equals_reference():
    for nnz in (1, 100, 1 << 14, 1 << 20):
        assert sparse.auto_p_chunk(nnz) == ref_sparse.auto_p_chunk(nnz)


# -- plain kernels against the Pallas kernels ----------------------------------


def _ell_inputs(spec: str, d: int, dtype: str, seed: int = 0):
    csr = ref_sparse.csr_from_graph(ref_topology.make(spec, seed=seed))
    n = csr.shape[0]
    p = np.random.default_rng(seed + 1).uniform(-1, 1, (n, d)).astype(np.float32)
    pj = jnp.asarray(p, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    pt = torch.from_numpy(p).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return csr, pj, pt


@pytest.mark.parametrize("spec,d", [("ba:n=40,m=3", 41), ("ring:n=37", 1), ("star:n=10", 130)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_kernels_match_the_pallas_kernels(spec, d, dtype):
    csr, pj, pt = _ell_inputs(spec, d, dtype)
    idx, val = ref_sparse.ell_from_csr(csr)
    bell = ref_sparse.block_ell_from_csr(csr)
    reset_launches()
    got = ops.gossip_mix_sparse(torch.from_numpy(idx), torch.from_numpy(val), pt)
    got_b = ops.gossip_mix_sparse_blocked(torch.from_numpy(bell.idx), torch.from_numpy(bell.val), pt)
    assert LAUNCHES == dict.fromkeys(LAUNCHES, 0)  # CPU tensors take the plain versions
    want = ref_ops.gossip_mix_sparse(jnp.asarray(idx), jnp.asarray(val), pj, interpret=True)
    want_b = ref_ops.gossip_mix_sparse_blocked(
        jnp.asarray(bell.idx), jnp.asarray(bell.val), pj, interpret=True)
    for g, w in ((got, want), (got_b, want_b)):
        assert g.dtype == pt.dtype and tuple(g.shape) == pt.shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **_tol(dtype))


def test_plain_kernels_accumulate_in_f32():
    """bf16 P: the sums run in f32 and round to bf16 once, at the end."""
    csr, _, pt = _ell_inputs("ring:n=37", 64, "bf16")
    bell = ref_sparse.block_ell_from_csr(csr)
    for fn, idx, val in ((sg.sparse_gossip_ref, *ref_sparse.ell_from_csr(csr)),
                         (sg.sparse_gossip_blocked_ref, bell.idx, bell.val)):
        idx, val = torch.from_numpy(idx), torch.from_numpy(val)
        got = fn(idx, val, pt)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, fn(idx, val, pt.float()).to(torch.bfloat16))


@pytest.mark.parametrize(
    "fn,idx_shape,val_shape,p_shape,err",
    [
        (ops.gossip_mix_sparse, (4, 2), (4, 3), (4, 5), ValueError),   # idx/val mismatch
        (ops.gossip_mix_sparse, (4, 2), (4, 2), (5, 5), ValueError),   # rows mismatch
        (ops.gossip_mix_sparse, (4,), (4,), (4, 5), ValueError),       # not 2-D
        (ops.gossip_mix_sparse_blocked, (1, 16), (8, 128), (9, 3), ValueError),  # NB != ceil(N/8)
        (ops.gossip_mix_sparse_blocked, (1, 16), (8, 120), (8, 3), ValueError),  # val shape
    ],
)
def test_wrappers_reject_bad_shapes(fn, idx_shape, val_shape, p_shape, err):
    with pytest.raises(err):
        fn(torch.zeros(idx_shape, dtype=torch.int32), torch.zeros(val_shape), torch.ones(p_shape))


def test_wrappers_reject_bad_types():
    idx, val = torch.zeros(4, 2, dtype=torch.int32), torch.zeros(4, 2)
    with pytest.raises(TypeError):
        ops.gossip_mix_sparse(idx, val, torch.ones(4, 3, dtype=torch.float16))
    with pytest.raises(TypeError):
        ops.gossip_mix_sparse(idx.float(), val, torch.ones(4, 3))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A missing nvcc raises; nothing falls back."""
    monkeypatch.setattr(sg, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nocuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        sg.build()


# -- staged rows and launch arguments ------------------------------------------

# Source rows read a column slab at N=1024 (chip_smoke.py phase 8 prints these
# beside the kernel times): a window of 1 row is a row gather reading every
# nonzero slot, 8 rows a blocked kernel reading each active tile column, and
# WINDOW_ROWS the windows of this design. Both layouts hold the same nonzeros,
# so they give the same count for any window of whole 8-row blocks.
STAGED_ROWS = {
    "ws:n=1024,k=8,beta=0.1": {1: 9216, 8: 2864, 16: 2358, 32: 2097, 64: 1930},
    "torus:rows=32,cols=32": {1: 5120, 8: 3328, 16: 3200, 32: 3072, 64: 2048},
    "caveman:cliques=128,size=8": {1: 8192, 8: 1280, 16: 1152, 32: 1088, 64: 1056},
}


@pytest.mark.parametrize("spec", list(STAGED_ROWS))
def test_staged_rows_of_the_large_n_layouts(spec):
    csr = sparse.csr_from_graph(topology.make(spec, seed=0))
    idx, val = sparse.ell_from_csr(csr)
    bell = sparse.block_ell_from_csr(csr)
    for window, want in STAGED_ROWS[spec].items():
        assert sg.staged_rows(idx, val, 1024, window, blocked=False) == want
        if window % sg.BLOCK_ROWS == 0:
            assert sg.staged_rows(bell.idx, bell.val, 1024, window, blocked=True) == want
    assert sg.WINDOW_ROWS in STAGED_ROWS[spec]


def test_staged_rows_skip_padding_and_rows_past_n():
    """Zero-weight ELL slots, all-zero tiles and the blocked layout's rows
    past N are never read; nor are the stacked periods' extra zero tiles."""
    csr = sparse.csr_from_graph(topology.make("ring:n=1001", seed=0))
    idx, val = sparse.ell_from_csr(csr)
    bell = sparse.block_ell_from_csr(csr)
    assert sg.staged_rows(idx, val, 1001, 1, blocked=False) == csr.nnz == 3003
    assert sg.staged_rows(bell.idx, bell.val, 1001, 1, blocked=True) == 3003
    other = sparse.csr_from_graph(topology.make("er:n=1001,p=0.01", seed=0))
    idx_st, val_st = sparse.stack_block_ell([csr, other])
    assert idx_st.shape[2] > bell.idx.shape[1]
    assert sg.staged_rows(torch.from_numpy(idx_st[0]), torch.from_numpy(val_st[0]), 1001, 16,
                          blocked=True) == sg.staged_rows(bell.idx, bell.val, 1001, 16, blocked=True)


def test_layout_args_are_int32_f32_and_16_byte_aligned():
    """The kernels take int32 indices and f32 weights starting on a 16-byte
    boundary (the blocked kernel reads a tile row 16 bytes at a time): other
    types are cast and an unaligned view is copied, an aligned one is not."""
    idx = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    flat = torch.arange(13, dtype=torch.float32)
    val = flat[1:].view(3, 4)
    assert val.data_ptr() % 16 != 0
    idx32, val32 = sg._layout_args(idx, val)
    assert idx32.dtype == torch.int32 and torch.equal(idx32.long(), idx)
    assert val32.data_ptr() % 16 == 0 and torch.equal(val32, val)
    aligned = torch.zeros(3, 4)
    assert sg._layout_args(idx32, aligned)[1].data_ptr() == aligned.data_ptr()
    assert sg._layout_args(idx32, aligned)[0].data_ptr() == idx32.data_ptr()


# -- mixing --------------------------------------------------------------------


@pytest.mark.parametrize("p_chunk", [None, 1, 7, 64, 4096])
def test_mix_sparse_matches_reference(p_chunk):
    csr_p, csr_r = _csr_pair("ba:n=40,m=3")
    params = _params(40)
    want = ref_sparse.mix_sparse(csr_r, jax.tree.map(jnp.asarray, params), p_chunk=p_chunk)
    got = sparse.mix_sparse(csr_p, params_from_numpy(params, "cpu"), p_chunk=p_chunk)
    _assert_trees_close(got, want, rtol=3e-5, atol=3e-5)


def test_mix_sparse_chunking_is_exact():
    csr, _ = _csr_pair("ws:n=40,k=4,beta=0.2")
    params = params_from_numpy(_params(40, seed=2), "cpu")
    want = sparse.mix_sparse(csr, params)
    for p_chunk in (1, 7, 64):
        got = sparse.mix_sparse(csr, params, p_chunk=p_chunk)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


def test_mix_sparse_bf16_leaves():
    csr_p, csr_r = _csr_pair("er:n=40,p=0.2")
    params = _params(40, seed=4)
    want = ref_sparse.mix_sparse(csr_r, jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params))
    got = sparse.mix_sparse(csr_p, {"a": torch.from_numpy(params["a"]).bfloat16(),
                                    "b": {"w": torch.from_numpy(params["b"]["w"]).bfloat16()}})
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(got))
    _assert_trees_close(got, want, **_tol("bf16"))


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("spec", ["ba:n=40,m=3", "ring:n=37"])
def test_mix_sparse_pallas_matches_reference(spec, blocked):
    csr_p = sparse.csr_from_graph(topology.make(spec, seed=1))
    csr_r = ref_sparse.csr_from_graph(ref_topology.make(spec, seed=1))
    n = csr_p.shape[0]
    params = _params(n, seed=5)
    want = ref_sparse.mix_sparse_pallas(csr_r, jax.tree.map(jnp.asarray, params),
                                        interpret=True, blocked=blocked)
    got = sparse.mix_sparse_pallas(csr_p, params_from_numpy(params, "cpu"), blocked=blocked)
    _assert_trees_close(got, want, rtol=3e-5, atol=3e-5)


# -- engine and program --------------------------------------------------------


def test_auto_resolves_to_sparse_at_512_nodes():
    for n, want in ((511, "dense"), (512, "sparse")):
        spec = f"ws:n={n},k=4,beta=0.1"
        assert decavg.GossipEngine(spec, device="cpu").backend == want
        assert ref_decavg.GossipEngine(spec).backend == want


def test_fused_backends_mirror_capabilities():
    caps = decavg.GossipEngine.capabilities()
    assert set(trainer._FUSED_BACKENDS) == {b for b, c in caps.items() if c["fused"]}
    ref_caps = ref_decavg.GossipEngine.capabilities()
    assert set(caps) == set(ref_caps)
    for b, info in caps.items():
        assert set(info) == set(ref_caps[b]) and info["fused"] == ref_caps[b]["fused"]
    assert trainer._FUSED_BACKENDS == ref_trainer._FUSED_BACKENDS
    assert set(trainer._LM_FUSED_BACKENDS) == set(ref_trainer._LM_FUSED_BACKENDS)


@pytest.mark.parametrize("backend,p_chunk", [("sparse", None), ("sparse", "auto"),
                                             ("sparse", 7), ("sparse_pallas", None)])
def test_engine_mix_matches_reference(backend, p_chunk):
    sizes = np.random.default_rng(2).integers(5, 40, size=40)
    kw = dict(data_sizes=sizes, backend=backend, sparse_p_chunk=p_chunk, seed=1)
    ref = ref_decavg.GossipEngine("ba:n=40,m=2@rewire=2", interpret=True, **kw)
    port = decavg.GossipEngine("ba:n=40,m=2@rewire=2", device="cpu", **kw)
    params = _params(40, seed=6)
    for r in range(4):  # crosses the period boundary at round 2
        port.refresh(r)
        ref.refresh(r)
        _assert_csr_equal(port.csr, ref.csr)
        want = ref.mix(jax.tree.map(jnp.asarray, params), round=r)
        got = port.mix(params_from_numpy(params, "cpu"), round=r)
        _assert_trees_close(got, want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("kind", ["dense", "sparse", "sparse_pallas"])
@pytest.mark.parametrize("gossip_every", [1, 3])
def test_program_apply_matches_reference(kind, gossip_every):
    spec = "er:n=20,p=0.3@rewire=2"
    sizes = np.random.default_rng(3).integers(5, 40, size=20)
    backend = "dense" if kind == "dense" else kind
    kw = dict(data_sizes=sizes, backend=backend, gossip_every=gossip_every, seed=2,
              sparse_p_chunk="auto" if kind == "sparse" else None)
    ref = ref_decavg.GossipEngine(spec, interpret=True, **kw).program(6, kind=kind)
    prog = decavg.GossipEngine(spec, device="cpu", **kw).program(6, kind=kind)
    assert (prog.kind, prog.n, prog.num_periods, prog.cadence, prog.rounds) == (
        ref.kind, ref.n, ref.num_periods, ref.cadence, ref.rounds)
    np.testing.assert_array_equal(prog.period_idx, np.asarray(ref.period_idx))
    np.testing.assert_array_equal(prog.gossip_mask, np.asarray(ref.gossip_mask))
    if kind == "sparse_pallas":
        np.testing.assert_array_equal(prog.bell_idx.numpy(), np.asarray(ref.bell_idx))
        np.testing.assert_array_equal(prog.bell_val.numpy(), np.asarray(ref.bell_val))
        assert prog.pad_ratio == pytest.approx(ref.pad_ratio)
    if kind == "sparse":
        assert prog.p_chunk == ref.p_chunk
    params = _params(20, seed=7)
    for r in range(6):
        want = ref.mix_at(jax.tree.map(jnp.asarray, params), jnp.int32(r))
        got = prog.mix_at(params_from_numpy(params, "cpu"), r)
        _assert_trees_close(got, want, rtol=3e-5, atol=3e-5)


def test_program_sparse_padding_is_exact():
    """Stacked periods pad the ELL to a common K with zero-weight slots: each
    period mixes bit-identically to the engine's own (unpadded) layout."""
    eng = decavg.GossipEngine("er:n=24,p=0.3@regen=1", backend="sparse", seed=0, device="cpu")
    prog = eng.program(4)
    assert prog.ell_idx.shape[0] == 4 and prog.pad_ratio > 1.0
    params = params_from_numpy(_params(24, seed=8), "cpu")
    for r in range(4):
        got = prog.apply(params, r)
        want = eng.mix(params, round=r)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


def test_program_validates_kind_and_rounds():
    """Every sparse kind stages, sparse_sharded over the default mesh (one
    shard on the CPU) even from a dense engine, as in the reference; an
    unknown kind or no rounds is refused."""
    eng = decavg.GossipEngine("ring:n=8", device="cpu")
    prog = eng.program(3, kind="sparse_sharded")
    assert prog.kind == "sparse_sharded" and prog.shards == 1 and prog.sh_ring_send == ()
    assert prog.sh_halo.shape == (1, 1, 8) and prog.mesh.shape == {"data": 1}
    assert eng.mesh is None
    with pytest.raises(ValueError, match="kind"):
        eng.program(3, kind="sharded")
    with pytest.raises(ValueError, match="rounds"):
        eng.program(0)
