"""Slice D, the parts under the LLM-cohort trainer, against the reference on
the same inputs: the token streams (byte for byte), the LR schedules, AdamW
(both of the port's forms), ``lm_loss``, the training forward with and
without remat, and ``node_loss_fn``'s loss and gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_cfgbase
from repro.data import tokens as ref_tok
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_TF
from repro.optim import adamw as ref_adamw
from repro.optim import schedules as ref_sched
from repro.train import losses as ref_losses
from repro_torch.configs import base as cfgbase
from repro_torch.convert import params_from_numpy
from repro_torch.data import tokens as tok
from repro_torch.launch import steps
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw, schedules
from repro_torch.train import losses
from repro_torch.train.trainer import _unflatten
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small operations: one intra-op thread is faster
    for them, and keeps the suite's parallel workers from oversubscribing
    the cores. The worker's setting is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
            vocab_size=256)


def _cfgs(**kw):
    return (dataclasses.replace(ref_cfgbase.get("llama32_1b").reduced(), **TINY, **kw),
            dataclasses.replace(cfgbase.get("llama32_1b").reduced(), **TINY, **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- tokens --------------------------------------------------------------------

@pytest.mark.parametrize("name,args,kw", [
    ("node_domain", (3, 512), {"seed": 7}),
    ("node_domain", (0, 128256), {"seed": 0, "domain_size": 16}),
    ("node_token_stream", (2, 5000, 512), {"seed": 1}),
    ("node_token_stream", (0, 3000, 128), {"seed": 0, "domain_frac": 0.0, "zipf_a": 1.5}),
    ("round_token_batch", (4, 5, 2, 16, 256), {"seed": 3}),
    ("round_token_batch", (2, 0, 4, 128, 128256), {"seed": 0}),
    ("round_token_batch", (6, 9, 2, 32, 512), {"seed": 1, "domain_frac": 0.6}),
    ("round_token_slab", (3, range(2, 6), 2, 8, 64), {"seed": 1}),
    ("domain_eval_batch", (4, 2, 16, 64), {"seed": 3}),
    ("domain_eval_batch", (6, 2, 32, 512), {"seed": 0, "domain_size": 32}),
    ("domain_query_batch", (2, 4, 32, 512), {"seed": 0, "query_round": 1}),
])
def test_tokens_equal_the_reference(name, args, kw):
    got, want = getattr(tok, name)(*args, **kw), getattr(ref_tok, name)(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_token_generators_equal_the_reference():
    a = list(tok.token_batches(3, 2, 8, 64, steps=3, seed=2))
    b = list(ref_tok.token_batches(3, 2, 8, 64, steps=3, seed=2))
    for (t1, l1), (t2, l2) in zip(a, b, strict=True):
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(l1, l2)
    rng1, rng2 = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(tok._zipf_tokens(rng1, 1.2, 4000, 64),
                                  ref_tok._zipf_tokens(rng2, 1.2, 4000, 64))
    with pytest.raises(ValueError, match=">= 2 nodes"):
        tok.domain_eval_batch(1, 2, 8, 64)


# -- schedules -----------------------------------------------------------------

# f32 relative tolerance of each schedule. cosine's 3e-7: torch's and XLA's
# f32 cos differ by up to 1 ulp (6e-8 absolute near cos = -1), which
# ``final_frac + 0.45 (1 + cos)`` carries to 2.7e-7 of an LR near its floor.
SCHED_RTOL = {"const": 1e-7, "wsd": 1e-7, "cosine": 3e-7}


@pytest.mark.parametrize("name,lr,total", [("const", 3e-4, 40), ("cosine", 3e-4, 40),
                                           ("cosine", 1e-3, 7), ("wsd", 3e-3, 50),
                                           ("wsd", 1e-3, 200)])
def test_schedules_match_the_reference(name, lr, total):
    port, ref = schedules.get(name, lr, total), ref_sched.get(name, lr, total)
    rounds = range(total + 3)
    got = np.array([float(port(r)) for r in rounds], np.float32)
    want = np.array([float(ref(r)) for r in rounds], np.float32)
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL[name], atol=0)
    # A round held as a tensor (a captured graph's buffer) gives the same bits.
    on_tensor = np.array([float(port(torch.tensor(r))) for r in rounds], np.float32)
    np.testing.assert_array_equal(on_tensor, got)
    assert port(torch.tensor(3)).dtype == torch.float32


def test_schedule_warmup_matches_the_reference():
    port = schedules.cosine(1e-3, 30, warmup=5, final_frac=0.2)
    ref = ref_sched.cosine(1e-3, 30, warmup=5, final_frac=0.2)
    np.testing.assert_allclose([float(port(r)) for r in range(32)],
                               [float(ref(r)) for r in range(32)], rtol=SCHED_RTOL["cosine"],
                               atol=0)
    with pytest.raises(ValueError, match="unknown schedule"):
        schedules.get("linear", 1e-3, 10)


# -- AdamW ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_the_reference_in_both_forms(dtype):
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 40), "b": [(3, 7, 5), (3,)]}
    params = {"a": rng.normal(size=shapes["a"]).astype(np.float32),
              "b": [rng.normal(size=s).astype(np.float32) for s in shapes["b"]]}
    ref_p = jax.tree.map(lambda x: jnp.asarray(x, dtype), params)
    ref_state = ref_adamw.init(ref_p)
    port_p = params_from_numpy(_np(ref_p), "cpu")
    state, state_ = adamw.init(port_p), adamw.init(port_p)
    port_p_ = [x.clone() for x in tree_leaves(port_p)]
    for step, lr in enumerate((1e-3, 3e-4, 0.0)):
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 10.0 ** -step,
                             params)
        ref_g = jax.tree.map(lambda x: jnp.asarray(x, dtype), grads)
        port_g = params_from_numpy(_np(ref_g), "cpu")
        ref_p, ref_state = ref_adamw.update(ref_g, ref_state, ref_p, lr=jnp.float32(lr))
        port_p, state = adamw.update(port_g, state, port_p, lr=torch.tensor(lr))
        adamw.update_(tree_leaves(port_g), state_, port_p_, lr=torch.tensor(lr))
        for got, want in zip(tree_leaves(port_p), jax.tree.leaves(ref_p)):
            assert got.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       rtol=0, atol=1e-6)
        for got, want in zip(tree_leaves(state.mu) + tree_leaves(state.nu),
                             jax.tree.leaves(ref_state.mu) + jax.tree.leaves(ref_state.nu)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        # The in-place form gives the same bits as the functional one.
        for a, b in zip(tree_leaves(port_p), port_p_):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(state), tree_leaves(state_)):
            assert torch.equal(a, b)
        assert int(state.count) == int(ref_state.count) == step + 1


def test_adamw_defaults_are_the_reference_s():
    import inspect

    got = inspect.signature(adamw.update).parameters
    want = inspect.signature(ref_adamw.update).parameters
    for k in ("b1", "b2", "eps", "weight_decay"):
        assert got[k].default == want[k].default
    state = adamw.init({"w": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert state.mu["w"].dtype == torch.float32 and state.count.dtype == torch.int32


# -- lm_loss, forward, node_loss_fn ----------------------------------------------

def test_lm_loss_matches_the_reference_with_ignored_labels():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 9, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, size=(2, 9)).astype(np.int32)
    labels[0, :4] = -1
    labels[1, -1] = -1
    got = losses.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want = ref_losses.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert abs(float(got) - float(want)) <= 1e-6
    all_ignored = losses.lm_loss(torch.from_numpy(logits), torch.full((2, 9), -1))
    assert float(all_ignored) == 0.0


@pytest.fixture(scope="module")
def model():
    ref_cfg, cfg = _cfgs()
    ref_p = ref_TF.init_params(jax.random.PRNGKey(3), ref_cfg)
    toks, labels = tok.round_token_batch(1, 0, 2, 16, cfg.vocab_size, seed=4)
    return ref_cfg, cfg, ref_p, params_from_numpy(_np(ref_p), "cpu"), toks[0], labels[0]


def test_forward_with_and_without_remat_and_against_the_reference(model):
    ref_cfg, cfg, ref_p, params, toks, labels = model
    t = torch.from_numpy(toks)
    plain, _ = TF.forward(params, cfg, t)
    remat, _ = TF.forward(params, cfg, t, remat=True)
    assert torch.equal(plain, remat)
    want, _ = ref_TF.forward(ref_p, ref_cfg, jnp.asarray(toks))
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=0, atol=1e-4)

    def grads(remat):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        logits, _ = TF.forward(_unflatten(params, leaves), cfg, t, remat=remat)
        return torch.autograd.grad(losses.lm_loss(logits, torch.from_numpy(labels)), leaves)

    for a, b in zip(grads(False), grads(True), strict=True):
        assert torch.equal(a, b)


def test_node_loss_fn_matches_the_reference(model):
    ref_cfg, cfg, ref_p, params, toks, labels = model
    batch = {"tokens": toks, "labels": labels}
    ref_loss, ref_grads = jax.value_and_grad(ref_steps.node_loss_fn(ref_cfg))(
        ref_p, jax.tree.map(jnp.asarray, batch))
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss = steps.node_loss_fn(cfg)(_unflatten(params, leaves),
                                   {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5
    for g, w in zip(grads, jax.tree.leaves(ref_grads), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
