"""The port's gossip_mix wrapper against the reference's Pallas kernel (in
interpret mode) and its jnp oracle, on the same numpy inputs.

On CPU tensors the wrapper takes its plain version; the CUDA kernel itself
is held to that plain version by tests/test_torch_cuda.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import gossip_mix as gm
from repro_torch.kernels import ops


def _tol(dtype):
    # bf16 keeps 8 bits of mantissa; f32 sums of <= 130 terms stay near 1e-6.
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bf16" else dict(rtol=3e-5, atol=3e-5)


def _block_sparse_w(n: int, seed: int) -> np.ndarray:
    """Row-stochastic W with whole zero blocks (so tiles can be skipped)."""
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32)
    half = n // 2
    w[:half, half:] = 0.0
    w[half:, : half // 2] = 0.0
    w[np.arange(n), np.arange(n)] += 1.0  # no empty row
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def _inputs(n: int, d: int, dtype: str, seed: int):
    w = _block_sparse_w(n, seed)
    p = np.random.default_rng(seed + 1).uniform(-1, 1, (n, d)).astype(np.float32)
    pj = jnp.asarray(p, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    pt = torch.from_numpy(p).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return w, pj, pt


@pytest.mark.parametrize("n,d", [(1, 1), (100, 700), (130, 513)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matches_reference_kernel_and_oracle(n, d, dtype):
    w, pj, pt = _inputs(n, d, dtype, seed=n + d)
    reset_launches()
    got = ops.gossip_mix(torch.from_numpy(w), pt)
    assert LAUNCHES["gossip_mix"] == 0  # CPU tensors take the plain version
    assert got.shape == (n, d) and got.dtype == pt.dtype
    got = got.float().numpy()
    kernel = np.asarray(ref_ops.gossip_mix(jnp.asarray(w), pj, interpret=True), np.float32)
    oracle = np.asarray(ref_oracle.gossip_mix_ref(jnp.asarray(w), pj), np.float32)
    np.testing.assert_allclose(got, kernel, **_tol(dtype))
    np.testing.assert_allclose(got, oracle, **_tol(dtype))


def test_plain_version_accumulates_in_f32():
    """bf16 P: the sum runs in f32 and rounds once, like the oracle."""
    w, pj, pt = _inputs(64, 96, "bf16", seed=3)
    got = gm.gossip_mix_ref(torch.from_numpy(w), pt)
    want = (torch.from_numpy(w) @ pt.float()).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "w_shape,p_shape,dtype,err",
    [
        ((4, 4), (5, 3), torch.float32, ValueError),   # contraction mismatch
        ((4,), (4, 3), torch.float32, ValueError),     # W not 2-D
        ((4, 4), (4, 3), torch.float16, TypeError),    # unsupported dtype
        ((4, 4), (4, 3), torch.int32, TypeError),
    ],
)
def test_wrapper_rejects_bad_inputs(w_shape, p_shape, dtype, err):
    with pytest.raises(err):
        ops.gossip_mix(torch.ones(w_shape), torch.ones(p_shape).to(dtype))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A missing nvcc raises; nothing falls back."""
    monkeypatch.setattr(gm, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nocuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        gm.build()


def test_build_key_tracks_the_source(tmp_path, monkeypatch):
    """A library built from other source text is never reused."""
    monkeypatch.setattr(gm, "_BUILD_DIR", tmp_path)
    stale = tmp_path / "libgossip_mix_0000000000000000.so"
    stale.write_bytes(b"")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nocuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        gm.build()
