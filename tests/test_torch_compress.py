"""The port's core/compress.py against the reference's: top-k CHOCO
compression per node and per leaf (the reference vmaps over nodes; the port
takes the node-stacked tree), the per-node k, the payload size, and the
reference's copies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as RC
from repro_torch.core import compress as C
from repro_torch.tree import tree_leaves

N = 6


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layers": [{"w": rng.standard_normal((N, 9, 7)).astype(np.float32),
                        "b": rng.standard_normal((N, 7)).astype(np.float32)},
                       {"w": rng.standard_normal((N, 7, 3)).astype(np.float32),
                        "b": rng.standard_normal((N, 1)).astype(np.float32)}]}


def _torch(tree):
    return {"layers": [{k: torch.as_tensor(v) for k, v in layer.items()}
                       for layer in tree["layers"]]}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("k_frac", [0.05, 0.25, 1.0])
def test_compress_matches_reference_over_rounds(k_frac):
    """Three rounds of compress with the params moving in between: the sent
    deltas and the references agree with the reference's vmapped ones."""
    params = _tree(0)
    state = C.init(_torch(params))
    ref_state = jax.vmap(RC.init)(_jax(params))
    for r in range(3):
        params = jax.tree.map(lambda a, b: a + 0.5 * b, params, _tree(r + 1))
        sent, state = C.compress(_torch(params), state, k_frac=k_frac)
        ref_sent, ref_state = jax.vmap(lambda p, s: RC.compress(p, s, k_frac=k_frac))(
            _jax(params), ref_state)
        for got, want in ((sent, ref_sent), (C.reconstruct(state), RC.reconstruct(ref_state))):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k_frac", [0.01, 0.2, 0.5])
def test_k_is_per_node_and_per_leaf(k_frac):
    params = _torch(_tree(3))
    sent, _ = C.compress(params, C.init({"layers": [
        {k: torch.zeros_like(v) for k, v in layer.items()} for layer in params["layers"]]}),
        k_frac=k_frac)
    for leaf, out in zip(tree_leaves(params), tree_leaves(sent)):
        per_node = leaf[0].numel()
        k = max(1, int(k_frac * per_node))
        assert (out.reshape(N, -1) != 0).sum(dim=1).tolist() == [k] * N
        # Each node sends its own k largest magnitudes.
        flat = leaf.reshape(N, -1).abs()
        kth = flat.topk(k, dim=1).values[:, -1:]
        assert ((out.reshape(N, -1) != 0) == (flat >= kth)).all()


def test_wire_bytes_matches_reference():
    tree = _tree()
    one_node = jax.tree.map(lambda a: a[0], tree)
    for k_frac in (0.01, 0.1, 1.0):
        assert C.wire_bytes(_torch(tree), k_frac=k_frac) == RC.wire_bytes(_jax(tree), k_frac=k_frac)
        assert C.wire_bytes(_torch(one_node), k_frac=k_frac) == RC.wire_bytes(
            _jax(one_node), k_frac=k_frac)


def test_init_copies_to_f32():
    params = _torch(_tree())
    params["layers"][0]["b"] = params["layers"][0]["b"].to(torch.bfloat16)
    state = C.init(params)
    for p, r in zip(tree_leaves(params), tree_leaves(state.reference)):
        assert r.dtype == torch.float32 and r.data_ptr() != p.data_ptr()
    w = params["layers"][1]["w"]
    before = state.reference["layers"][1]["w"].clone()
    w.add_(1.0)
    assert torch.equal(state.reference["layers"][1]["w"], before)


def test_reference_catches_up():
    """The residual re-enters the selection: a fixed target is reached once
    every entry has been sent, ceil(size / k) rounds for each leaf."""
    target = _torch(_tree(5))
    state = C.init({"layers": [{k: torch.zeros_like(v) for k, v in layer.items()}
                               for layer in target["layers"]]})
    sizes = [leaf[0].numel() for leaf in tree_leaves(target)]
    rounds = max(-(-s // max(1, int(0.25 * s))) for s in sizes)
    assert rounds == 7  # the 7-entry bias, one entry a round
    for r in range(rounds):
        assert r < rounds - 1 or not torch.equal(state.reference["layers"][0]["b"],
                                                 target["layers"][0]["b"])
        _, state = C.compress(target, state, k_frac=0.25)
    for t, r in zip(tree_leaves(target), tree_leaves(state.reference)):
        torch.testing.assert_close(r, t, rtol=0, atol=0)
