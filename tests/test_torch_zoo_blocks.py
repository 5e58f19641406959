"""The zoo's blocks in the port against the JAX reference, on the same numpy
inputs and weights (f32, small widths, the CPU): the MoE FFN (one routing
group and several, the dense residual, a capacity that drops tokens), the
Mamba block and the RWKV-6 time and channel mixing, over a full sequence and
through their caches (a prompt, then single steps), all at 1e-5; Mamba's
in-chunk scan bit for bit against ``jax.lax.associative_scan``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as JMb
from repro.models import moe as JMoe
from repro.models import rwkv as JRk
from repro_torch.convert import params_from_numpy
from repro_torch.models import mamba as TMb
from repro_torch.models import moe as TMoe
from repro_torch.models import rwkv as TRk

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small operations: one intra-op thread is faster for them and
    keeps the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def _x(shape, seed, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# -- MoE -----------------------------------------------------------------------

MOE_CASES = {
    # name: (MoESpec kwargs, (B, S))
    "one_group": (dict(num_experts=4, top_k=2, d_ff=48), (2, 9)),
    "groups_padded": (dict(num_experts=4, top_k=2, d_ff=48, group_size=8), (2, 11)),
    "dense_residual": (dict(num_experts=4, top_k=2, d_ff=48, dense_residual=True,
                            dense_d_ff=40), (2, 9)),
    "capacity_drops": (dict(num_experts=4, top_k=2, d_ff=48, capacity_factor=0.25), (2, 16)),
    "top1_eight_experts": (dict(num_experts=8, top_k=1, d_ff=32, group_size=6), (3, 7)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches(case):
    kw, (b, s) = MOE_CASES[case]
    d = 24
    pj = _np(JMoe.init_moe(jax.random.PRNGKey(0), d, JMoe.MoESpec(**kw), jnp.float32))
    pt = params_from_numpy(pj, "cpu")
    x = _x((b, s, d), 1)
    yj, aj = JMoe.moe_ffn(pj, jnp.asarray(x), JMoe.MoESpec(**kw))
    yt, at = TMoe.moe_ffn(pt, torch.from_numpy(x), TMoe.MoESpec(**kw))
    _close(yt, yj)
    _close(at, aj)
    if case == "capacity_drops":  # some token rows dropped entirely
        assert (np.linalg.norm(yt.numpy().reshape(-1, d), axis=1) < 1e-9).any()


def test_moe_ties_go_to_the_lower_expert():
    """Zero rows (group padding) have uniform router probabilities: every
    choice is a tie, which the reference's top_k gives to the lower expert
    indices; the aux loss reads those choices."""
    spec_kw = dict(num_experts=4, top_k=2, d_ff=16, group_size=4)
    d = 8
    pj = _np(JMoe.init_moe(jax.random.PRNGKey(3), d, JMoe.MoESpec(**spec_kw), jnp.float32))
    pt = params_from_numpy(pj, "cpu")
    x = np.zeros((1, 6, d), np.float32)
    x[0, :2] = _x((2, d), 4)
    yj, aj = JMoe.moe_ffn(pj, jnp.asarray(x), JMoe.MoESpec(**spec_kw))
    yt, at = TMoe.moe_ffn(pt, torch.from_numpy(x), TMoe.MoESpec(**spec_kw))
    _close(yt, yj)
    _close(at, aj)


def test_moe_gradients_match_through_checkpointed_groups():
    kw = dict(num_experts=4, top_k=2, d_ff=32, group_size=8)
    d = 16
    pj = _np(JMoe.init_moe(jax.random.PRNGKey(5), d, JMoe.MoESpec(**kw), jnp.float32))
    x = _x((2, 10, d), 6)

    def loss_j(p):
        y, aux = JMoe.moe_ffn(p, jnp.asarray(x), JMoe.MoESpec(**kw))
        return jnp.sum(y**2) + aux

    gj = jax.grad(loss_j)(jax.tree.map(jnp.asarray, pj))
    pt = {k: v.requires_grad_(True) for k, v in params_from_numpy(pj, "cpu").items()}
    y, aux = TMoe.moe_ffn(pt, torch.from_numpy(x), TMoe.MoESpec(**kw))
    (torch.sum(y**2) + aux).backward()
    for k in pt:
        _close(pt[k].grad, gj[k])


# -- Mamba ----------------------------------------------------------------------

D_MODEL = 16


def _mamba(chunk=4, seed=0):
    spec_kw = dict(d_state=8, chunk=chunk)
    pj = _np(JMb.init_mamba(jax.random.PRNGKey(seed), D_MODEL, JMb.MambaSpec(**spec_kw),
                            jnp.float32))
    return JMb.MambaSpec(**spec_kw), TMb.MambaSpec(**spec_kw), pj, params_from_numpy(pj, "cpu")


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 64])
def test_mamba_in_chunk_scan_is_the_reference_associative_scan(n):
    """The port's in-chunk scan is ``lax.associative_scan``'s odd/even
    recursion with the reference's combine: the same f32 bits."""
    def combine(left, right):
        (al, bl), (ar, br) = left, right
        return al * ar, bl * ar + br

    rng = np.random.default_rng(n)
    a = rng.random((2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
    ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = TMb._prefix_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("s,chunk", [(11, 4), (16, 4), (5, 8), (40, 16)])
def test_mamba_block_full_sequence_matches(s, chunk):
    sj, st, pj, pt = _mamba(chunk)
    x = _x((2, s, D_MODEL), s)
    yj, _ = JMb.mamba_block(pj, jnp.asarray(x), sj)
    yt, none = TMb.mamba_block(pt, torch.from_numpy(x), st)
    assert none is None
    _close(yt, yj)


def test_mamba_block_cache_prompt_then_steps_match():
    """A prompt into a zero cache, then single steps: outputs and both
    states at 1e-5; the port's cache is the one it was given, updated."""
    sj, st, pj, pt = _mamba(4, seed=1)
    cj = JMb.init_mamba_cache(2, D_MODEL, sj, jnp.float32)
    ct = TMb.init_mamba_cache(2, D_MODEL, st, torch.float32, "cpu")
    given = ct
    x = _x((2, 7, D_MODEL), 2)
    yj, cj = JMb.mamba_block(pj, jnp.asarray(x), sj, cache=cj)
    yt, ct = TMb.mamba_block(pt, torch.from_numpy(x), st, cache=ct)
    _close(yt, yj)
    for t in range(5):
        x1 = _x((2, 1, D_MODEL), 10 + t)
        yj, cj = JMb.mamba_block(pj, jnp.asarray(x1), sj, cache=cj)
        yt, ct = TMb.mamba_block(pt, torch.from_numpy(x1), st, cache=ct)
        _close(yt, yj)
    assert ct is given
    for key in ("conv", "ssm"):
        _close(ct[key], cj[key])


def test_mamba_bf16_keeps_the_f32_leaves():
    """In a bf16 model a_log, dt_bias and d_skip stay f32 and the SSM state
    f32; the output is bf16. Held to the reference at bf16's tolerance."""
    spec_kw = dict(d_state=8, chunk=4)
    pj = _np(JMb.init_mamba(jax.random.PRNGKey(7), D_MODEL, JMb.MambaSpec(**spec_kw),
                            jnp.bfloat16))
    pt = params_from_numpy(pj, "cpu")
    assert {k: str(v.dtype) for k, v in pt.items() if v.dtype == torch.float32} == {
        "dt_bias": "torch.float32", "a_log": "torch.float32", "d_skip": "torch.float32"}
    x = _x((2, 9, D_MODEL), 8)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    yj, _ = JMb.mamba_block(pj, xj, JMb.MambaSpec(**spec_kw))
    xt = params_from_numpy(np.asarray(xj), "cpu")
    yt, _ = TMb.mamba_block(pt, xt, TMb.MambaSpec(**spec_kw))
    assert yt.dtype == torch.bfloat16
    _close(yt, np.asarray(yj, np.float32), dict(rtol=2e-2, atol=2e-2))


# -- RWKV-6 ---------------------------------------------------------------------


def _rwkv(chunk=4, seed=0):
    spec_kw = dict(head_dim=8, decay_lora=4, chunk=chunk)
    pj = _np(JRk.init_rwkv(jax.random.PRNGKey(seed), D_MODEL, JRk.RWKVSpec(**spec_kw),
                           jnp.float32))
    return JRk.RWKVSpec(**spec_kw), TRk.RWKVSpec(**spec_kw), pj, params_from_numpy(pj, "cpu")


@pytest.mark.parametrize("s,chunk", [(13, 4), (8, 8), (3, 4), (33, 8)])
def test_rwkv_block_full_sequence_matches(s, chunk):
    sj, st, pj, pt = _rwkv(chunk)
    x = _x((2, s, D_MODEL), s, 0.5)
    yj, _ = JRk.rwkv_block(pj, jnp.asarray(x), sj)
    yt, _ = TRk.rwkv_block(pt, torch.from_numpy(x), st)
    _close(yt, yj)


def test_rwkv_block_decays_at_the_clamp_match():
    """Large decay-LoRA weights push the log-decay to both clamp ends."""
    sj, st, pj, pt = _rwkv(4, seed=2)
    pj = dict(pj, w_lora_b=pj["w_lora_b"] * 200.0)
    pt = params_from_numpy(pj, "cpu")
    x = _x((1, 12, D_MODEL), 3)
    yj, _ = JRk.rwkv_block(pj, jnp.asarray(x), sj)
    yt, _ = TRk.rwkv_block(pt, torch.from_numpy(x), st)
    _close(yt, yj)


def test_rwkv_block_and_ffn_cache_prompt_then_steps_match():
    sj, st, pj, pt = _rwkv(4, seed=3)
    fj = _np(JRk.init_rwkv_ffn(jax.random.PRNGKey(4), D_MODEL, 40, jnp.float32))
    ft = params_from_numpy(fj, "cpu")
    cj = JRk.init_rwkv_cache(2, D_MODEL, sj, jnp.float32)
    ct = TRk.init_rwkv_cache(2, D_MODEL, st, torch.float32, "cpu")
    fcj = {"shift": jnp.zeros((2, D_MODEL))}
    fct = {"shift": torch.zeros(2, D_MODEL)}
    xs = [_x((2, 6, D_MODEL), 5, 0.5)] + [_x((2, 1, D_MODEL), 20 + t, 0.5) for t in range(5)]
    for x in xs:
        yj, cj = JRk.rwkv_block(pj, jnp.asarray(x), sj, cache=cj)
        yt, ct = TRk.rwkv_block(pt, torch.from_numpy(x), st, cache=ct)
        _close(yt, yj)
        zj, fcj = JRk.rwkv_ffn(fj, jnp.asarray(x), cache=fcj)
        zt, fct = TRk.rwkv_ffn(ft, torch.from_numpy(x), cache=fct)
        _close(zt, zj)
    for key in ("shift", "wkv"):
        _close(ct[key], cj[key])
    _close(fct["shift"], fcj["shift"])


def test_rwkv_ffn_full_sequence_matches():
    fj = _np(JRk.init_rwkv_ffn(jax.random.PRNGKey(6), D_MODEL, 40, jnp.float32))
    x = _x((2, 9, D_MODEL), 7)
    yj, _ = JRk.rwkv_ffn(fj, jnp.asarray(x))
    yt, none = TRk.rwkv_ffn(params_from_numpy(fj, "cpu"), torch.from_numpy(x))
    assert none is None
    _close(yt, yj)
