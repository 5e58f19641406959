"""The ELL slot sum on the CPU: the wrapper's checks, its plain version
against a numpy loop in slot order, and the ``sparse``/``sparse_sharded``
mixes giving the same bits whatever their ``p_chunk``. The kernel itself
runs only on the card (``tests/test_torch_cuda.py``). No jax here."""

import numpy as np
import pytest
import torch

from repro_torch.core import decavg, mesh, sparse, topology
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels import ell_sum as es
from repro_torch.tree import tree_leaves


def _layout(n: int, k: int, h: int, seed: int, dtype=torch.int64):
    """(n, k) slots into h source rows, a third of them weighing 0, row 1
    all padding (weight 0 at source 0)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, h, size=(n, k))
    val = rng.standard_normal((n, k)).astype(np.float32)
    val[rng.random((n, k)) < 1 / 3] = 0.0
    idx[1], val[1] = 0, 0.0
    return torch.from_numpy(idx).to(dtype), torch.from_numpy(val)


def _numpy_slot_loop(idx, val, src) -> np.ndarray:
    """Each row from slot 0's product, then each later product added, every
    product and sum rounded to f32 (numpy does not fuse them)."""
    idx, val, src = idx.numpy().astype(np.int64), val.numpy(), src.numpy()
    out = np.empty((idx.shape[0], src.shape[1]), np.float32)
    for i in range(idx.shape[0]):
        acc = val[i, 0] * src[idx[i, 0]]
        for k in range(1, idx.shape[1]):
            acc = acc + val[i, k] * src[idx[i, k]]
        out[i] = acc
    return out


@pytest.mark.parametrize(
    "idx_shape,val_shape,src_shape",
    [
        ((4,), (4,), (4, 3)),         # idx and val not 2-D
        ((4, 2), (4, 2), (12,)),      # src not 2-D
        ((4, 2, 1), (4, 2, 1), (4, 3)),
        ((4, 2), (4, 3), (4, 3)),     # idx and val differ
        ((4, 2), (5, 2), (4, 3)),
        ((4, 0), (4, 0), (4, 3)),     # no slot
    ],
)
def test_ell_sum_rejects_bad_shapes(idx_shape, val_shape, src_shape):
    with pytest.raises(ValueError):
        ops.ell_sum(torch.zeros(idx_shape, dtype=torch.int64), torch.zeros(val_shape),
                    torch.ones(src_shape))


@pytest.mark.parametrize(
    "idx_dtype,val_dtype,src_dtype",
    [
        (torch.float32, torch.float32, torch.float32),   # float indices
        (torch.int16, torch.float32, torch.float32),
        (torch.int64, torch.float64, torch.float32),     # val not f32
        (torch.int64, torch.bfloat16, torch.float32),
        (torch.int64, torch.float32, torch.float64),     # src not f32
        (torch.int32, torch.float32, torch.bfloat16),
    ],
)
def test_ell_sum_rejects_bad_types(idx_dtype, val_dtype, src_dtype):
    with pytest.raises(TypeError):
        ops.ell_sum(torch.zeros(4, 2, dtype=idx_dtype), torch.zeros(4, 2, dtype=val_dtype),
                    torch.ones(4, 3, dtype=src_dtype))


@pytest.mark.parametrize("which", ["idx", "val", "src"])
def test_ell_sum_rejects_mixed_devices(which):
    args = {"idx": torch.zeros(4, 2, dtype=torch.int64), "val": torch.zeros(4, 2),
            "src": torch.ones(4, 3)}
    args[which] = args[which].to("meta")
    with pytest.raises(ValueError, match="on meta"):
        ops.ell_sum(**args)


def test_ell_sum_refuses_a_device_it_does_not_run_on():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.ell_sum(torch.zeros(4, 2, dtype=torch.int64, device="meta"),
                    torch.zeros(4, 2, device="meta"), torch.ones(4, 3, device="meta"))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("r,k,h,d", [(7, 5, 7, 1), (16, 3, 40, 10), (9, 33, 12, 513), (1, 1, 1, 64)])
def test_cpu_takes_the_plain_version_in_slot_order(monkeypatch, idx_dtype, r, k, h, d):
    """A CPU call is ``ell_sum_ref``, equal to the numpy slot loop to the
    bit, for R != H source rows, zero-weight slots and an all-padding row."""
    idx, val = _layout(max(r, 2), k, h, seed=r * 100 + d, dtype=idx_dtype)
    idx, val = idx[:r], val[:r]
    src = torch.from_numpy(np.random.default_rng(d).standard_normal((h, d)).astype(np.float32))
    calls = []
    ref = es.ell_sum_ref
    monkeypatch.setattr(es, "ell_sum_ref", lambda *a: calls.append(1) or ref(*a))
    got = ops.ell_sum(idx, val, src)
    assert calls == [1] and got.dtype == torch.float32 and got.shape == (r, d)
    assert torch.equal(got, torch.from_numpy(_numpy_slot_loop(idx, val, src)))


def test_cpu_plain_version_reads_strided_sources():
    """A source whose rows are a column slice (an unaligned start, rows
    d + 3 apart) gives the bits of its contiguous copy."""
    idx, val = _layout(12, 6, 20, seed=5)
    big = torch.randn(20, 70, generator=torch.Generator().manual_seed(0))
    src = big[:, 1:68]
    assert not src.is_contiguous()
    assert torch.equal(ops.ell_sum(idx, val, src), ops.ell_sum(idx, val, src.contiguous()))


def _tree(n: int, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {"b": torch.randn(n, 10, generator=gen), "w": torch.randn(n, 24, 10, generator=gen),
            "s": torch.randn(n, generator=gen)}


@pytest.mark.parametrize("spec", ["ba:n=64,m=2", "ws:n=48,k=4,beta=0.3"])
def test_mix_ell_gives_the_same_bits_with_and_without_p_chunk(spec):
    csr = sparse.csr_from_graph(topology.make(spec, seed=0))
    idx, val = (torch.as_tensor(a) for a in sparse.ell_from_csr(csr))
    params = _tree(csr.shape[0], seed=1)
    want = sparse.mix_ell(idx.long(), val, params)
    for p_chunk in (1, 7, 64, 240, 4096):
        got = sparse.mix_ell(idx.long(), val, params, p_chunk=p_chunk)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


@pytest.mark.parametrize("shards", [1, 4])
def test_shard_rows_give_the_same_bits_with_and_without_p_chunk(shards):
    """Each shard's rows over its halo buffer (H != R with 4 shards), in
    column slabs or whole, equal to the rows of the whole matrix's sum."""
    csr = sparse.csr_from_graph(topology.make("ba:n=64,m=2", seed=0))
    views = sparse.ShardedELL.from_csr(sparse.shard_csr(csr, shards), torch.device("cpu")).shard_views(
        [torch.device("cpu")] * shards)
    x = torch.randn(64, 37, generator=torch.Generator().manual_seed(2))
    idx, val = (torch.as_tensor(a) for a in sparse.ell_from_csr(csr))
    whole = ops.ell_sum(idx.long(), val, x)
    blk = 64 // shards
    for s, view in enumerate(views):
        buf = decavg._halo_buffer(view, x[s * blk:(s + 1) * blk], [x], ring=False)
        if shards > 1:
            assert buf.shape[0] != view.rows_per_shard
        want = decavg._shard_rows(view, buf, None)
        assert torch.equal(want, whole[s * blk:(s + 1) * blk])
        for p_chunk in (1, 5, 36, 64):
            assert torch.equal(decavg._shard_rows(view, buf, p_chunk), want)


def test_launches_stay_zero_on_the_cpu():
    """The plain version counts no launch: not alone, not through ``sparse``
    or ``sparse_sharded`` on 4 CPU shards."""
    reset_launches()
    idx, val = _layout(8, 4, 8, seed=3)
    ops.ell_sum(idx, val, torch.ones(8, 5))
    params = _tree(64, seed=4)
    m = mesh.Mesh([torch.device("cpu")] * 4, ("data",))
    for backend, kw in (("sparse", {}), ("sparse_sharded", {"mesh": m})):
        decavg.GossipEngine("ba:n=64,m=2", backend=backend, seed=1, device="cpu", **kw).mix(params)
    assert "ell_sum" in LAUNCHES and not any(LAUNCHES.values())


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A missing nvcc raises; nothing falls back."""
    monkeypatch.setattr(es, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nocuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        es.build()
