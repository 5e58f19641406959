"""Serving the zoo in the port against the JAX reference, on the reference's
weights (reduced configs, f32, the CPU): ``prefill_forward`` and
``decode_step`` logits and caches at 1e-4, greedy ``generate`` tokens
identical to JAX's for every arch, chunked prefill against the port's own
token-by-token prefill (2e-5, the reference's test_serve.py tolerance), the
continuous-batching Engine on the attention-only zoo archs, and the serve
CLI for every arch with ``--device cpu``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.models import transformer as JTF
from repro.serve import decode as JSD
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import base as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as TTF
from repro_torch.serve import decode as TSD
from repro_torch.serve.engine import Engine, engine_ok
from repro_torch.tree import tree_leaves

ZOO = ["jamba_v01_52b", "dbrx_132b", "arctic_480b", "rwkv6_3b", "whisper_base", "internvl2_76b"]
TOL = dict(rtol=1e-4, atol=1e-4)
SEQ_TOL = dict(rtol=2e-5, atol=2e-5)


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


@functools.lru_cache(maxsize=None)
def _memory(arch: str, b: int):
    """Encoder memory of stub frames in both packages (None unless enc-dec)."""
    cj, ct, pj, pt = _models(arch)
    if not cj.enc_dec:
        return None, None
    frames = (np.random.default_rng(2).standard_normal((b, 10, cj.d_model))
              * cj.d_model**-0.5).astype(np.float32)
    return JTF.encode(pj, cj, jnp.asarray(frames)), TTF.encode(pt, ct, torch.from_numpy(frames))


def _tokens(shape, vocab, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _caches_close(ct, cj):
    lj = jax.tree.leaves(cj)
    lt = [t for t in tree_leaves(ct) if t is not None]
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        _close(a, b)


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_decode_match(arch):
    cj, ct, pj, pt = _models(arch)
    mj, mt = _memory(arch, 2)
    toks = _tokens((2, 12), cj.vocab_size)
    lg_j, cache_j = JSD.prefill(pj, cj, jnp.asarray(toks), JTF.init_cache(cj, 2, 32),
                                memory=mj, flash=False)
    lg_t, cache_t = TSD.prefill(pt, ct, torch.from_numpy(toks),
                                TTF.init_cache(ct, 2, 32, device="cpu"), memory=mt,
                                flash=TSD.flash_ok(ct))
    _close(lg_t, lg_j)
    _caches_close(cache_t, cache_j)
    tok = np.asarray(jnp.argmax(lg_j, axis=-1)).astype(np.int32)
    for _ in range(4):
        lj, cache_j = JTF.decode_step(pj, cj, jnp.asarray(tok), cache_j, memory=mj)
        lt, cache_t = TTF.decode_step(pt, ct, torch.from_numpy(tok), cache_t, memory=mt)
        _close(lt, lj)
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    _caches_close(cache_t, cache_j)


@pytest.mark.parametrize("arch", ZOO)
def test_generate_matches_the_reference_greedy(arch):
    cj, ct, pj, pt = _models(arch)
    mj, mt = _memory(arch, 2)
    prompt = _tokens((2, 9), cj.vocab_size, seed=3)
    want = JSD.generate(pj, cj, jnp.asarray(prompt), JTF.init_cache(cj, 2, 32), steps=8,
                        key=jax.random.PRNGKey(0), memory=mj)
    got = TSD.generate(pt, ct, torch.from_numpy(prompt), TTF.init_cache(ct, 2, 32, device="cpu"),
                       steps=8, memory=mt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jamba_dense_ffn(cfg):
    """jamba's Mamba/attention pattern with dense FFNs: no MoE routing, so
    chunked and token-by-token prefill must agree."""
    pattern = tuple(dataclasses.replace(s, ffn="dense") for s in cfg.pattern)
    return dataclasses.replace(cfg, pattern=pattern, moe=None)


@pytest.mark.parametrize("arch", ["jamba_dense_ffn", "rwkv6_3b", "whisper_base",
                                  "internvl2_76b"])
def test_chunked_prefill_matches_the_port_sequential_prefill(arch):
    """The reference's guard: one forward writes what feeding the prompt
    token by token writes (13 tokens: a ragged Mamba/RWKV chunk), and both
    continue alike. MoE patterns are excepted: a prompt routes as one group,
    decode as groups of one token."""
    if arch == "jamba_dense_ffn":
        ct = _jamba_dense_ffn(tcfg.get("jamba_v01_52b").reduced())
        pt, mt = TTF.init_params(0, ct, device="cpu"), None
    else:
        _, ct, _, pt = _models(arch)
        mt = _memory(arch, 2)[1]
    toks = torch.from_numpy(_tokens((2, 13), ct.vocab_size))
    lg_c, cache_c = TSD.prefill(pt, ct, toks, TTF.init_cache(ct, 2, 32, device="cpu"),
                                memory=mt, flash=False)
    lg_s, cache_s = TSD.prefill_sequential(pt, ct, toks, TTF.init_cache(ct, 2, 32, device="cpu"),
                                           memory=mt)
    _close(lg_c, lg_s.numpy(), SEQ_TOL)
    tok = lg_c.argmax(dim=-1)
    for _ in range(4):
        lc, cache_c = TTF.decode_step(pt, ct, tok, cache_c, memory=mt)
        ls, cache_s = TTF.decode_step(pt, ct, tok, cache_s, memory=mt)
        _close(lc, ls.numpy(), SEQ_TOL)
        tok = lc.argmax(dim=-1)


@pytest.mark.parametrize("arch", ZOO)
def test_engine_admits_the_attention_only_zoo_archs(arch):
    """dbrx, arctic and internvl2 (attention mixers, no encoder) serve
    through the Engine; jamba and rwkv6 (recurrent mixers) and whisper
    (enc-dec) are refused, as in the reference."""
    _, ct, _, pt = _models(arch)
    ok = arch in ("dbrx_132b", "arctic_480b", "internvl2_76b")
    assert engine_ok(ct) is ok
    if ok:
        eng = Engine(pt, ct, slots=2, cache_len=16, device="cpu")
        rid = eng.submit([1, 2, 3], max_new=2)
        assert eng.run()[rid].shape == (2,)
    else:
        with pytest.raises(ValueError, match="attention-only"):
            Engine(pt, ct, slots=2, cache_len=16, device="cpu")


def test_engine_matches_the_reference_engine_and_generate_internvl2():
    cj, ct, pj, pt = _models("internvl2_76b")
    prompts = [_tokens((n,), cj.vocab_size, seed=10 + n) for n in (5, 11, 3)]

    def drive(eng):
        rids = [eng.submit(p, max_new=6) for p in prompts]
        out = eng.run()
        return [np.asarray(out[r]) for r in rids]

    want = drive(JEngine(pj, cj, slots=2, cache_len=24, flash=False))
    got = drive(Engine(pt, ct, slots=2, cache_len=24, device="cpu"))
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g, w)
        alone = TSD.generate(pt, ct, torch.from_numpy(p)[None],
                             TTF.init_cache(ct, 1, 24, device="cpu"), steps=6)
        np.testing.assert_array_equal(g, alone[0].numpy())


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "dbrx-132b", "arctic-480b", "rwkv6-3b",
                                  "whisper-base", "internvl2-76b"])
def test_serve_cli_serves_every_zoo_arch_on_the_cpu(arch, capsys):
    toks = serve_cli.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len",
                           "5", "--gen", "4"])
    out = capsys.readouterr().out
    assert tuple(toks.shape) == (2, 4)
    assert f"arch={arch}-reduced batch=2 cache_len=9" in out and "generated (2, 4)" in out
