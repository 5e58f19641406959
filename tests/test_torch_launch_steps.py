"""The port's step builders (``launch/steps.py``) and functional SGD
(``optim/sgd.py``) against the JAX reference on the same numpy inputs.

``build_train_step`` at N=4 reduced llama members (each its own draw), 2
steps with a ring's DecAvg matrix: loss within 1e-5; params within 1e-5 for
SGD with 1 and 2 microbatches, and for AdamW with 1 and 2 microbatches on
all but at most 1 in 10,000 entries of a leaf. The per-node gradients agree
within 6e-7, but AdamW's first steps move a weight by about
``lr * g / |g|``: where a gradient entry is rounding noise (|g| < 1e-7, a
few dozen of the 1.1 M here) the two packages may disagree on its sign,
and that entry moves up to ``2 lr`` apart (measured: 6 entries of a
262,144-entry leaf, the largest 7.3e-5 at lr 1e-3). Those stay within
``2 lr`` a step. ``build_prefill_step`` and ``build_serve_step``:
tokens identical to the reference's, on a windowed ring cache, an MoE arch,
the VLM prefix and whisper with its encoder memory. ``sgd.update`` leaf by
leaf at 1e-6, weight decay and bf16 momentum included.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.launch import steps as JST
from repro.models import transformer as JTF
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch.configs import base as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as TTF
from repro_torch.optim import adamw, sgd
from repro_torch.tree import tree_leaves, tree_map

N, SEQ = 4, 16
W_RING = np.array([[.5, .25, 0, .25], [.25, .5, .25, 0], [0, .25, .5, .25], [.25, 0, .25, .5]],
                  np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    cj, ct = jcfg.get(arch).reduced(), tcfg.get(arch).reduced()
    pj = JTF.init_params(jax.random.PRNGKey(0), cj)
    return cj, ct, pj, _t(pj)


def _close(port, ref, atol):
    for g, w in zip(tree_leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32),
                                   rtol=0, atol=atol)


# -- functional SGD ----------------------------------------------------------------


@pytest.mark.parametrize("mom_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_sgd_update_matches_reference(weight_decay, mom_dtype):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": {"w": rng.standard_normal((7,)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    tp = _t(params)
    jstate = jsgd.init(jp, dtype=getattr(jnp, mom_dtype) if mom_dtype else None)
    tstate = sgd.init(tp, dtype=getattr(torch, mom_dtype) if mom_dtype else None)
    assert isinstance(tstate, sgd.SGDState)
    for step in range(3):
        g = jax.tree.map(lambda x, s=step: np.cos(x * (s + 1)).astype(np.float32), params)
        jp, jstate = jsgd.update(jax.tree.map(jnp.asarray, g), jstate, jp, lr=0.1,
                                 weight_decay=weight_decay)
        tp, tstate = sgd.update(_t(g), tstate, tp, lr=0.1, weight_decay=weight_decay)
    tol = 1e-2 if mom_dtype else 1e-6
    _close(tp, jp, tol)
    _close(tstate.momentum, jstate.momentum, tol)


# -- build_train_step --------------------------------------------------------------------


def _batch(cfg, microbatches: int, seed: int):
    rng = np.random.default_rng(seed)
    per = 2 // microbatches
    toks = rng.integers(0, cfg.vocab_size, (microbatches, N, per, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


@pytest.mark.parametrize("optimizer,microbatches",
                         [("adamw", 1), ("adamw", 2), ("sgd", 1), ("sgd", 2)])
def test_train_step_matches_reference(optimizer, microbatches):
    cj, ct, _, _ = _models("llama32_1b")
    # every member its own draw, so the gossip mixes different weights
    jp = jax.tree.map(lambda *xs: jnp.stack(xs),
                      *[JTF.init_params(jax.random.PRNGKey(i), cj) for i in range(N)])
    tp = _t(jp)
    jopt = jadamw.init(jp) if optimizer == "adamw" else jsgd.init(jp)
    topt = adamw.init(tp) if optimizer == "adamw" else sgd.init(tp)
    kw = dict(num_nodes=N, microbatches=microbatches, optimizer=optimizer, lr=1e-3)
    jstep = jax.jit(JST.build_train_step(cj, **kw))
    tstep = ST.build_train_step(ct, **kw)
    w = torch.as_tensor(W_RING)
    for s in range(2):
        b = _batch(cj, microbatches, seed=s)
        jp, jopt, jloss = jstep(jp, jopt, jnp.asarray(W_RING), jax.tree.map(jnp.asarray, b))
        tp, topt, tloss = tstep(tp, topt, w, _t(b))
        assert abs(float(tloss) - float(jloss)) <= 1e-5
    if optimizer == "sgd":
        _close(tp, jp, 1e-5)
        return
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        d = np.abs(g.numpy() - np.asarray(w))
        assert int((d > 1e-5).sum()) <= d.size // 10_000, int((d > 1e-5).sum())
        assert d.max() <= 2 * 2 * kw["lr"]


def test_train_step_takes_a_custom_mix():
    """``mix_fn`` replaces the dense gossip: called once a step with the
    matrix; at lr 0 the parameters come back as they went in."""
    _, ct, _, pt = _models("llama32_1b")
    stacked = tree_map(lambda x: torch.stack([x] * 2), pt)
    calls = []

    def mix(w, params):
        calls.append(w)
        return params

    step = ST.build_train_step(ct, num_nodes=2, optimizer="sgd", lr=0.0, mix_fn=mix)
    b = {k: torch.as_tensor(v[:, :2]) for k, v in _batch(ct, 1, 0).items()}
    new, state, loss = step(stacked, sgd.init(stacked), torch.eye(2), b)
    assert len(calls) == 1 and torch.isfinite(loss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(stacked)))
    assert any(bool(m.abs().sum() > 0) for m in tree_leaves(state.momentum))


# -- build_prefill_step / build_serve_step -----------------------------------------------


def _frames(cfg, b):
    return (np.random.default_rng(2).standard_normal((b, 10, cfg.d_model))
            * cfg.d_model**-0.5).astype(np.float32)


@pytest.mark.parametrize("arch", ["llama32_1b", "dbrx_132b", "internvl2_76b", "whisper_base"])
def test_prefill_step_matches_reference(arch):
    cj, ct, pj, pt = _models(arch)
    toks = np.random.default_rng(1).integers(0, cj.vocab_size, (3, 12)).astype(np.int32)
    batch = {"tokens": toks}
    if cj.enc_dec:
        batch["frames"] = _frames(cj, 3)
    if arch == "internvl2_76b":
        batch["prefix_embeds"] = _frames(cj, 3)[:, :4]
    want = JST.build_prefill_step(cj)(pj, jax.tree.map(jnp.asarray, batch))
    got = ST.build_prefill_step(ct)(pt, _t(batch))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,window,cache_len", [
    ("llama32_1b", None, 16),
    ("llama32_1b", 6, 6),  # a windowed ring that wraps
    ("jamba_v01_52b", None, 16),
    ("whisper_base", None, 16),
])
def test_serve_step_matches_reference(arch, window, cache_len):
    cj, ct, pj, pt = _models(arch)
    b = 3
    jmem = tmem = None
    if cj.enc_dec:
        f = _frames(cj, b)
        jmem = JTF.encode(pj, cj, jnp.asarray(f))
        tmem = TTF.encode(pt, ct, torch.as_tensor(f))
    jstep = JST.build_serve_step(cj, window=window)
    tstep = ST.build_serve_step(ct, window=window)
    jc = JTF.init_cache(cj, b, cache_len)
    tc = TTF.init_cache(ct, b, cache_len, device="cpu")
    t = np.array([1, 2, 3], np.int32)
    for _ in range(10):
        jt, jc = jstep(pj, jnp.asarray(t), jc, memory=jmem)
        tt, tc = tstep(pt, torch.as_tensor(t), tc, memory=tmem)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        t = np.array(jt)
