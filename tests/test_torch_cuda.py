"""The port's CUDA code on the card: the gossip_mix kernel against its plain
version, and the two mixing backends against each other.

Every test here is marked ``cuda`` and skips without a card. The file imports
neither jax nor the reference package, so it also runs where only PyTorch is
installed, without the suite's conftest:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import decavg
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import gossip_mix as gm
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
