"""Serving in the port against the JAX reference on the same weights: the
model (forward, prefill, decode), generation, the continuous-batching Engine,
checkpoints both ways, and the serve CLI, all on the CPU at reduced sizes.

Weights are drawn by JAX and carried across with ``convert``. Logits hold
1e-4 (the reference's flash-vs-reference prefill tolerance, test_serve.py);
greedy tokens are identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jcfg
from repro.models import transformer as JTF
from repro.serve import decode as JSD
from repro.serve.engine import Engine as JEngine
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import base as tcfg
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as TTF
from repro_torch.serve import decode as TSD
from repro_torch.serve.engine import Engine, _bucket, engine_ok
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    """The reduced config in both packages and the same f32 weights."""
    cj, ct = jcfg.get(arch).reduced(), tcfg.get(arch).reduced()
    pj = JTF.init_params(jax.random.PRNGKey(0), cj)
    return cj, ct, pj, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


def _tokens(shape, vocab, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _caches_close(ct, cj):
    lj = jax.tree.leaves(cj)
    lt = [t for t in tree_leaves(ct) if t is not None]
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        _close(a, b)


@pytest.mark.parametrize("arch", ["llama32_1b", "stablelm_3b"])
def test_forward_prefill_and_decode_match(arch):
    cj, ct, pj, pt = _models(arch)
    toks = _tokens((2, 16), cj.vocab_size)
    lj, _ = JTF.forward(pj, cj, jnp.asarray(toks))
    lt, aux = TTF.forward(pt, ct, torch.from_numpy(toks))
    _close(lt, lj)
    assert float(aux) == 0.0
    _close(TTF.forward(pt, ct, torch.from_numpy(toks), last_only=True)[0], lj[:, -1])

    lg_j, cache_j = JSD.prefill(pj, cj, jnp.asarray(toks), JTF.init_cache(cj, 2, 32), flash=True)
    caches = {}
    for flash in (True, False):
        lg_t, caches[flash] = TSD.prefill(pt, ct, torch.from_numpy(toks),
                                          TTF.init_cache(ct, 2, 32, device="cpu"), flash=flash)
        _close(lg_t, lg_j)
        _caches_close(caches[flash], cache_j)
    # four decode steps continue both caches alike
    cache_t = caches[True]
    tok = np.asarray(jnp.argmax(lg_j, axis=-1)).astype(np.int32)
    for _ in range(4):
        lj, cache_j = JTF.decode_step(pj, cj, jnp.asarray(tok), cache_j)
        lt, cache_t = TTF.decode_step(pt, ct, torch.from_numpy(tok), cache_t)
        _close(lt, lj)
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    _caches_close(cache_t, cache_j)


def test_chunked_prefill_matches_the_port_sequential_prefill():
    """The port's own guard, as the reference's: one forward writes what
    feeding the prompt token by token writes, and both continue alike. Each
    decode step advances its own cache in place."""
    _, ct, _, pt = _models("llama32_1b")
    toks = torch.from_numpy(_tokens((2, 12), ct.vocab_size))
    lg_c, cache_c = TSD.prefill(pt, ct, toks, TTF.init_cache(ct, 2, 32, device="cpu"), flash=False)
    lg_s, cache_s = TSD.prefill_sequential(pt, ct, toks, TTF.init_cache(ct, 2, 32, device="cpu"))
    _close(lg_c, lg_s.numpy(), dict(rtol=2e-5, atol=2e-5))
    tok = lg_c.argmax(dim=-1)
    for _ in range(4):
        lc, cache_c = TTF.decode_step(pt, ct, tok, cache_c)
        ls, cache_s = TTF.decode_step(pt, ct, tok, cache_s)
        _close(lc, ls.numpy(), dict(rtol=2e-5, atol=2e-5))
        tok = lc.argmax(dim=-1)


def test_int8_kv_cache_matches():
    cj, ct, pj, pt = _models("llama32_1b")
    toks = _tokens((2, 10), cj.vocab_size)
    lj, cache_j = JSD.prefill(pj, cj, jnp.asarray(toks), JTF.init_cache(cj, 2, 16, kv_quant=True),
                              flash=False)
    lt, cache_t = TSD.prefill(pt, ct, torch.from_numpy(toks),
                              TTF.init_cache(ct, 2, 16, kv_quant=True, device="cpu"))
    _close(lt, lj)
    tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for _ in range(3):
        lj, cache_j = JTF.decode_step(pj, cj, jnp.asarray(tok), cache_j)
        lt, cache_t = TTF.decode_step(pt, ct, torch.from_numpy(tok), cache_t)
        _close(lt, lj)
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)


def test_right_padded_per_slot_prefill_matches():
    cj, ct, pj, pt = _models("llama32_1b")
    lens = np.array([5, 9, 12], np.int32)
    padded = _tokens((3, 12), cj.vocab_size)
    for i, n in enumerate(lens):
        padded[i, n:] = 0
    lj, cache_j = JSD.prefill(pj, cj, jnp.asarray(padded), JTF.init_cache(cj, 3, 32, per_slot=True),
                              length=jnp.asarray(lens), flash=False)
    for flash in (False, True):
        lt, cache_t = TSD.prefill(pt, ct, torch.from_numpy(padded),
                                  TTF.init_cache(ct, 3, 32, per_slot=True, device="cpu"),
                                  length=torch.from_numpy(lens), flash=flash)
        _close(lt, lj)
        _caches_close(cache_t, cache_j)
    tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for _ in range(3):  # per-slot decode: each row at its own position
        lj, cache_j = JTF.decode_step(pj, cj, jnp.asarray(tok), cache_j)
        lt, cache_t = TTF.decode_step(pt, ct, torch.from_numpy(tok), cache_t)
        _close(lt, lj)
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)


@pytest.mark.parametrize("case", ["overflow", "scalar_index"])
def test_prefill_guards_raise_before_writing(case):
    """The reference's two ValueErrors: right-padded rows with a prompt wider
    than the ring, and per-row lengths with a shared-index cache. The port
    raises before touching the cache."""
    _, ct, _, pt = _models("llama32_1b")
    if case == "overflow":
        prompt, ring, lens, per_slot, match = (2, 24), 16, [20, 24], True, "padded"
    else:
        prompt, ring, lens, per_slot, match = (2, 8), 16, [4, 6], False, "per-slot"
    cache = TTF.init_cache(ct, 2, ring, per_slot=per_slot, device="cpu")
    with pytest.raises(ValueError, match=match):
        TSD.prefill(pt, ct, torch.from_numpy(_tokens(prompt, ct.vocab_size)), cache,
                    length=torch.tensor(lens, dtype=torch.int32), flash=False)
    assert all(not t.any() for t in tree_leaves(cache) if t is not None)


def test_prompt_longer_than_the_window_ring_matches():
    """A prompt wider than the ring, windowed: the chunked prefill lands the
    reference's ring state and continues past another revolution alike."""
    cj, ct, pj, pt = _models("llama32_1b")
    window = cj.sliding_window  # 16 in reduced configs
    toks = _tokens((2, 24), cj.vocab_size)
    lj, cache_j = JSD.prefill(pj, cj, jnp.asarray(toks), JTF.init_cache(cj, 2, window),
                              window=window, flash=False)
    lt, cache_t = TSD.prefill(pt, ct, torch.from_numpy(toks),
                              TTF.init_cache(ct, 2, window, device="cpu"), window=window)
    _close(lt, lj)
    _caches_close(cache_t, cache_j)
    tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for _ in range(window + 2):
        lj, cache_j = JTF.decode_step(pj, cj, jnp.asarray(tok), cache_j, window=window)
        lt, cache_t = TTF.decode_step(pt, ct, torch.from_numpy(tok), cache_t, window=window)
        _close(lt, lj)
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)


def test_init_cache_gives_each_group_its_own_tensors():
    _, ct, _, _ = _models("llama32_1b")
    assert ct.num_groups == 2
    cache = TTF.init_cache(ct, 2, 8, device="cpu")
    k = cache["layer0"]["mixer"]["k"]
    k[0].fill_(1.0)
    assert not k[1].any()


def test_generate_matches_the_reference_greedy():
    cj, ct, pj, pt = _models("llama32_1b")
    prompt = _tokens((2, 5), cj.vocab_size)
    want = JSD.generate(pj, cj, jnp.asarray(prompt), JTF.init_cache(cj, 2, 32), steps=6,
                        key=jax.random.PRNGKey(2))
    got = TSD.generate(pt, ct, torch.from_numpy(prompt), TTF.init_cache(ct, 2, 32, device="cpu"),
                       steps=6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_matches_the_reference_engine_and_generate():
    """Four requests through two slots, two arriving late, cache_len 24 (not
    a power of two: the 20-token prompt's pad bucket is capped at 24). The
    port's tokens are the reference Engine's, and each is what the port's
    ``generate`` gives for that prompt alone."""
    cj, ct, pj, pt = _models("llama32_1b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cj.vocab_size, size=n).astype(np.int32) for n in (5, 9, 3, 20)]
    max_new = [6, 4, 5, 6]

    def drive(eng):
        r0 = eng.submit(prompts[0], max_new=max_new[0])
        r1 = eng.submit(prompts[1], max_new=max_new[1])
        eng.step()
        eng.step()
        r2 = eng.submit(prompts[2], max_new=max_new[2])
        r3 = eng.submit(prompts[3], max_new=max_new[3])
        out = eng.run()
        assert sorted(out) == [r0, r1, r2, r3]
        return [out[r] for r in (r0, r1, r2, r3)]

    want = drive(JEngine(pj, cj, slots=2, cache_len=24, flash=False))
    reset_launches()
    got = drive(Engine(pt, ct, slots=2, cache_len=24, flash=True, device="cpu"))
    assert LAUNCHES["flash_attention"] == 0  # CPU tensors take the plain version
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    for p, n, g in zip(prompts, max_new, got):
        alone = TSD.generate(pt, ct, torch.from_numpy(p)[None],
                             TTF.init_cache(ct, 1, 24, device="cpu"), steps=n)
        np.testing.assert_array_equal(g, alone[0].numpy())


def test_engine_streams_and_retires():
    assert _bucket(1) == 8 and _bucket(8) == 8 and _bucket(9) == 16
    _, ct, _, pt = _models("llama32_1b")
    eng = Engine(pt, ct, slots=2, cache_len=32, device="cpu")
    rid = eng.submit([1, 2, 3], max_new=3)
    events = []
    for ev in iter(eng.step, []):
        events.extend(ev)
    assert [e["rid"] for e in events] == [rid] * 3
    assert [e["done"] for e in events] == [False, False, True]
    rid2 = eng.submit([4, 5], max_new=1)
    out = eng.run()
    assert sorted(out) == [rid, rid2] and out[rid2].shape == (1,)
    assert np.array_equal(out[rid], [e["token"] for e in events])


def test_engine_submit_guards():
    _, ct, _, pt = _models("llama32_1b")
    eng = Engine(pt, ct, slots=2, cache_len=16, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new=2)
    with pytest.raises(ValueError, match="cache_len"):
        eng.submit(list(range(1, 18)), max_new=2)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit([1, 2], max_new=0)
    ok = eng.submit(list(range(1, 17)), max_new=2)  # exactly cache_len fits
    assert eng.run()[ok].shape == (2,)


def test_engine_rejects_recurrent_patterns_and_foreign_params():
    _, ct, _, pt = _models("llama32_1b")
    rwkv = dataclasses.replace(ct, pattern=(tcfg.LayerSpec("rwkv", "rwkv"),))
    assert engine_ok(ct) and not engine_ok(rwkv)
    with pytest.raises(ValueError, match="attention-only"):
        Engine(pt, rwkv, slots=2, cache_len=16, device="cpu")
    with pytest.raises(ValueError, match="parameters are on"):
        Engine(pt, ct, slots=2, cache_len=16, device="meta")


def test_engine_sampling_is_seeded():
    """temperature > 0 cannot match JAX's bits: the port's draws depend only
    on the seed, and stay in the vocabulary."""
    _, ct, _, pt = _models("llama32_1b")

    def run(seed):
        eng = Engine(pt, ct, slots=2, cache_len=32, temperature=0.8, seed=seed, device="cpu")
        a = eng.submit([1, 2, 3, 4], max_new=6)
        b = eng.submit([9, 8], max_new=6)
        out = eng.run()
        return np.concatenate([out[a], out[b]])

    first = run(5)
    assert first.shape == (12,) and first.min() >= 0 and first.max() < ct.vocab_size
    np.testing.assert_array_equal(first, run(5))
    assert not np.array_equal(first, run(6))


def test_a_jax_bf16_checkpoint_restores_in_the_port(tmp_path):
    cj, ct, pj, _ = _models("stablelm_3b")
    pj16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), pj)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, {"params": pj16, "step": jnp.asarray(3)}, step=3)
    ct16 = dataclasses.replace(ct, param_dtype="bfloat16")
    like = TTF.init_params(1, ct16, device="cpu")
    got, step = tckpt.restore_subtree(path, like, prefix="params")
    assert step == 3
    want = params_from_numpy(jax.tree.map(np.asarray, pj16), "cpu")
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), b.view(torch.int16))
    toks = torch.from_numpy(_tokens((1, 8), ct.vocab_size))
    assert torch.equal(TTF.forward(got, ct16, toks)[0], TTF.forward(want, ct16, toks)[0])
    full, step = tckpt.restore(path, {"params": like, "step": torch.zeros((), dtype=torch.int32)})
    assert step == 3 and int(full["step"]) == 3
    with pytest.raises(KeyError, match="prefixes"):
        tckpt.restore_subtree(path, like, prefix="opt")


def test_a_port_checkpoint_restores_in_jax_byte_for_byte(tmp_path):
    cj, ct, pj, _ = _models("llama32_1b")
    ct16 = dataclasses.replace(ct, param_dtype="bfloat16")
    pt16 = TTF.init_params(7, ct16, device="cpu")
    cache = TTF.init_cache(ct, 1, 4, device="cpu")  # int32 and None leaves too
    path = str(tmp_path / "port.npz")
    tckpt.save(path, {"params": pt16, "cache": cache}, step=11)
    like = {"params": jax.tree.map(lambda x: x.astype(jnp.bfloat16), pj),
            "cache": JTF.init_cache(cj, 1, 4)}
    got, step = jckpt.restore(path, like)
    assert step == 11
    want = params_to_numpy({"params": pt16, "cache": cache})
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_serve_cli_on_the_cpu(capsys):
    toks = serve_cli.main(["--device", "cpu", "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    out = capsys.readouterr().out
    assert "arch=llama3.2-1b-reduced batch=2 cache_len=9" in out and "generated (2, 4)" in out
