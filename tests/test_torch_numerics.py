"""Why the port's CUDA kernels split their operands, checked on the CPU.

``gossip_mix.cu`` computes ``W @ P`` on the tensor cores in TF32 (10 stored
mantissa bits) and must hold the reference's 3e-5 in f32. These tests
emulate TF32 rounding (``cvt.rna``: round to nearest, ties away from zero, on
the int32 view of each f32) on the main path's mixing matrix (BA N=100,
decavg weights over the hub_focused data sizes) and a (100, 4096) leaf from
numpy seed 0, with products summed in f64, and pin three facts: one TF32
product misses 3e-5; the 3xTF32 split (big * big + big * small + small * big)
holds it; and a bf16 P is exact in TF32, so splitting W alone (two products)
holds it too.

They also pin the flash-attention wrapper's alignment rule (16-byte strides
and starts, which the kernel's 16-byte asynchronous copies need) on CPU
tensors.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import topology
from repro_torch.core.decavg import GossipEngine
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.experiments.runner import build_partition
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.kernels import flash_attention as fa

TOL = 3e-5  # the reference's f32 tolerance for gossip_mix

MAIN_SPEC = dict(topology="ba:n=100,m=2", partitioner="hub_focused", rounds=6, eval_every=2,
                 batch_size=32, lr=0.05, momentum=0.9)


def tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 values to TF32 (10 mantissa bits), to nearest, ties away from 0."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    big = tf32(x)
    return big, tf32(x - big)


def mm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a.astype(np.float64) @ b.astype(np.float64)


def bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.fixture(scope="module")
def main_w() -> np.ndarray:
    """The main path's W, built as the runner builds it."""
    spec = ExperimentSpec(**MAIN_SPEC)
    ds = make_mnist_like(**spec.data)
    graph = topology.make_schedule(spec.topology, seed=spec.seed).graph_at(0)
    sizes = np.array([len(p) for p in build_partition(spec, graph, ds.y_train)], dtype=np.float64)
    w = GossipEngine(spec.topology, data_sizes=sizes, backend="dense", seed=spec.seed,
                     device="cpu").w
    return w.numpy().astype(np.float32)


@pytest.fixture(scope="module")
def leaf() -> np.ndarray:
    return np.random.default_rng(0).uniform(-1.0, 1.0, (100, 4096)).astype(np.float32)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11), 3.0],
                 dtype=np.float32)
    # 1 + 2^-11 is half way between two TF32 values: away from zero.
    want = np.array([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0, -(1.0 + 2.0**-10), 3.0],
                    dtype=np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    assert not (tf32(x).view(np.uint32) & np.uint32(0x1FFF)).any()


def test_main_path_w_is_row_stochastic_and_sparse(main_w):
    assert main_w.shape == (100, 100)
    np.testing.assert_allclose(main_w.sum(axis=1), 1.0, atol=1e-6)
    assert (main_w != 0).sum() < 0.1 * main_w.size


@pytest.mark.parametrize("operands", ["main_w", "uniform_w"])
def test_one_tf32_product_misses_the_tolerance(operands, main_w, leaf):
    w = main_w if operands == "main_w" else np.full((100, 100), 0.01, dtype=np.float32)
    err = np.abs(mm(tf32(w), tf32(leaf)) - mm(w, leaf)).max()
    assert err > TOL


@pytest.mark.parametrize("operands", ["main_w", "uniform_w"])
def test_three_tf32_products_hold_the_tolerance(operands, main_w, leaf):
    w = main_w if operands == "main_w" else np.full((100, 100), 0.01, dtype=np.float32)
    wb, ws = split(w)
    pb, ps = split(leaf)
    got = mm(wb, pb) + mm(wb, ps) + mm(ws, pb)
    err = np.abs(got - mm(w, leaf)).max()
    assert err <= TOL / 100  # the dropped small * small term is about 2^-22 relative
    # ...and the split itself is near f32's own rounding.
    np.testing.assert_allclose(wb.astype(np.float64) + ws, w, rtol=2.0**-21, atol=0)


def test_bf16_p_is_exact_in_tf32_so_two_products_suffice(main_w, leaf):
    p = bf16(leaf)
    np.testing.assert_array_equal(tf32(p), p)
    wb, ws = split(main_w)
    got = mm(wb, p) + mm(ws, p)
    want = mm(main_w, p)
    assert np.abs(got - want).max() <= TOL / 100
    # One product (W in TF32) is not enough even before the bf16 output rounding.
    assert np.abs(mm(wb, p) - want).max() > TOL


def test_split_of_zero_w_entries_is_exact_zero(main_w):
    wb, ws = split(main_w)
    zero = main_w == 0
    assert (wb[zero] == 0).all() and (ws[zero] == 0).all()


# -- the flash-attention wrapper's alignment rule ------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_projection_layouts_are_aligned(dtype, hd):
    """attention_layer's q, k, v: a projection reshaped to (B, S, H, hd)."""
    x = torch.zeros(2, 7, 12 * hd, dtype=dtype)
    q = x.reshape(2, 7, 12, hd)
    assert fa._aligned(q)
    assert fa._aligned(q[:, :, 4:6])  # a KV head slice of a fused projection
    assert fa._aligned(q[:, 3:])


def test_alignment_rule_counts_bytes_not_values():
    f32 = torch.zeros(1, 4, 3, 68)
    b16 = torch.zeros(1, 4, 3, 68, dtype=torch.bfloat16)
    # A start 4 values in: 16 bytes in f32, 8 bytes in bf16.
    assert fa._aligned(f32[..., 4:])
    assert not fa._aligned(b16[..., 4:])
    assert fa._aligned(torch.zeros(1, 4, 3, 72, dtype=torch.bfloat16)[..., 8:])
    # Rows of 68 bf16 values are 136 bytes apart: not a multiple of 16.
    assert not fa._aligned(b16)
    assert fa._aligned(f32)
    # The last dimension must be contiguous.
    assert not fa._aligned(torch.zeros(1, 4, 64, 3).transpose(2, 3))
