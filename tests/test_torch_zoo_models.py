"""The zoo's models in the port against the JAX reference: each of the six
archs (jamba, dbrx, arctic, rwkv6, whisper, internvl2) at its reduced
config, f32, on the CPU, with the reference's weights carried over by
``convert``: ``forward`` logits at 1e-4 and the MoE aux loss at 1e-5, the
encoder, the VLM prefix, and ``init_params`` trees with the reference's
keys, shapes and dtypes (full configs on the ``meta`` device).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro_torch.configs import base as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.models import frontends
from repro_torch.models import transformer as TTF

ZOO = ["jamba_v01_52b", "dbrx_132b", "arctic_480b", "rwkv6_3b", "whisper_base", "internvl2_76b"]
TOL = dict(rtol=1e-4, atol=1e-4)
AUX_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small operations: one intra-op thread is faster for them and
    keeps the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    cj, ct = jcfg.get(arch).reduced(), tcfg.get(arch).reduced()
    pj = JTF.init_params(jax.random.PRNGKey(0), cj)
    return cj, ct, pj, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def _tokens(shape, vocab, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _embeds(shape, seed) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * shape[-1] ** -0.5).astype(
        np.float32)


def _memory(cj, ct, pj, pt, b=2, t=10):
    frames = _embeds((b, t, cj.d_model), 2)
    mj = JTF.encode(pj, cj, jnp.asarray(frames))
    mt = TTF.encode(pt, ct, torch.from_numpy(frames))
    return mj, mt


def _leaf_specs(tree, prefix=()):
    """{path: (shape, dtype name)} of a parameter tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_specs(v, prefix + (k,)))
        return out
    dtype = str(tree.dtype).removeprefix("torch.")
    return {"/".join(prefix): (tuple(tree.shape), dtype)}


@pytest.mark.parametrize("arch", ZOO)
def test_forward_matches(arch):
    cj, ct, pj, pt = _models(arch)
    toks = _tokens((2, 12), cj.vocab_size)
    kw_j, kw_t = {}, {}
    if cj.enc_dec:
        kw_j["memory"], kw_t["memory"] = _memory(cj, ct, pj, pt)
    lj, aj = JTF.forward(pj, cj, jnp.asarray(toks), **kw_j)
    lt, at = TTF.forward(pt, ct, torch.from_numpy(toks), **kw_t)
    assert lt.shape == lj.shape
    _close(lt, lj)
    _close(at, aj, AUX_TOL)
    if any(s.ffn == "moe" for s in ct.pattern):
        assert float(at) > 0.0
    _close(TTF.forward(pt, ct, torch.from_numpy(toks), last_only=True, **kw_t)[0], lj[:, -1])


@pytest.mark.parametrize("arch", ["jamba_v01_52b", "dbrx_132b"])
def test_forward_with_remat_and_several_routing_groups_matches(arch):
    """Group size 8 over 2 x 12 tokens: three routing groups (the last
    padded), checkpointed in the port, under the forward's remat too."""
    import dataclasses

    cj, ct, pj, pt = _models(arch)
    cj = dataclasses.replace(cj, moe=dataclasses.replace(cj.moe, group_size=8))
    ct = dataclasses.replace(ct, moe=dataclasses.replace(ct.moe, group_size=8))
    toks = _tokens((2, 12), cj.vocab_size, seed=4)
    lj, aj = JTF.forward(pj, cj, jnp.asarray(toks), remat=True)
    with torch.enable_grad():
        lt, at = TTF.forward(pt, ct, torch.from_numpy(toks), remat=True)
    _close(lt, lj)
    _close(at, aj, AUX_TOL)


def test_encode_matches():
    cj, ct, pj, pt = _models("whisper_base")
    mj, mt = _memory(cj, ct, pj, pt, b=2, t=37)
    assert tuple(mt.shape) == (2, 37, ct.d_model)
    _close(mt, mj)


def test_encode_above_the_dense_threshold_matches_dense_attention(monkeypatch):
    """At T = 2100 frames (above 2048^2 logits, not a multiple of the KV
    chunk) the port's encoder takes its chunked attention, which masks the
    padding past T; the reference's chunked loop attends it as zero keys,
    so the port is held to the reference with its dense attention."""
    cj, ct, pj, pt = _models("whisper_base")
    real = JL.attention
    monkeypatch.setattr(JL, "attention", functools.partial(real, dense_threshold=1 << 62))
    frames = _embeds((1, 2100, cj.d_model), 3)
    mj = JTF.encode.__wrapped__(pj, cj, jnp.asarray(frames))
    mt = TTF.encode(pt, ct, torch.from_numpy(frames))
    _close(mt, mj)


def test_vlm_prefix_matches():
    cj, ct, pj, pt = _models("internvl2_76b")
    toks = _tokens((2, 9), cj.vocab_size)
    prefix = _embeds((2, 3, cj.d_model), 5)
    lj, _ = JTF.forward(pj, cj, jnp.asarray(toks), prefix_embeds=jnp.asarray(prefix))
    lt, _ = TTF.forward(pt, ct, torch.from_numpy(toks), prefix_embeds=torch.from_numpy(prefix))
    assert tuple(lt.shape) == (2, 12, ct.vocab_size)
    _close(lt, lj)


def test_frontend_stubs_have_the_reference_shapes_and_scale():
    cfg = tcfg.get("whisper_base")
    gen = torch.Generator().manual_seed(0)
    frames = frontends.audio_frames(gen, cfg, 2, 1500)
    patches = frontends.patch_embeddings(gen, tcfg.get("internvl2_76b").reduced(), 3, 8)
    assert frames.shape == (2, 1500, 512) and frames.dtype == torch.bfloat16
    assert patches.shape == (3, 8, 256) and patches.dtype == torch.float32
    assert abs(float(frames.float().std()) - 512**-0.5) < 2e-3
    again = frontends.audio_frames(torch.Generator().manual_seed(0), cfg, 2, 1500)
    assert torch.equal(frames, again)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ZOO)
def test_init_params_tree_has_the_reference_layout(arch, reduced):
    """Keys, shapes and dtypes leaf for leaf: the full configs on the meta
    device (nothing drawn) against ``jax.eval_shape``."""
    cj, ct = jcfg.get(arch), tcfg.get(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
        pt = TTF.init_params(0, ct, device="cpu")
    else:
        pt = TTF.init_params(0, ct, device="meta")
    pj = jax.eval_shape(lambda: JTF.init_params(jax.random.PRNGKey(0), cj))
    assert _leaf_specs(pt) == _leaf_specs(pj)
    assert TTF.param_count(pt) == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(pj))
