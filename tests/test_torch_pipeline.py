"""The port's pipeline-parallel decoders (``serve/gpipe.py``,
``serve/pipeline.py``, ``serve/pipeline_manual.py``) against the JAX
reference's ``decode_step`` on the reference's weights (f32, the CPU).

The reduced llama in the shape of the reference's own manual-pipeline test
(4 layers, 4/2 heads, d 128) decodes 4 steps from fixed tokens on meshes of
the CPU repeated (``make_host_mesh``): tokens identical, plain caches within
1e-5, int8 caches within one quantization level (scales 1e-5 relative).
The GPipe helpers' own cases, the bubble (2S-1 ticks at S=4 never touch a
real row, ``index`` bumped once a step) and the dispatch errors are ported
from the reference's ``tests/test_pipeline.py``.
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
from repro_torch.configs import base as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.launch import mesh as LM
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as TTF
from repro_torch.serve import gpipe
from repro_torch.serve import pipeline as PL
from repro_torch.serve import pipeline_manual as PM

SHAPE = dict(num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32, d_model=128,
             d_ff=256, vocab_size=512)
B, T, STEPS = 4, 16, 4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(shape: tuple = tuple(SHAPE.items())):
    cj = dataclasses.replace(jcfg.get("llama32_1b").reduced(), **dict(shape))
    ct = dataclasses.replace(tcfg.get("llama32_1b").reduced(), **dict(shape))
    pj = JTF.init_params(jax.random.PRNGKey(0), cj)
    return cj, ct, pj, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


@functools.lru_cache(maxsize=None)
def _reference(kv_quant: bool, shape: tuple = tuple(SHAPE.items())):
    """JAX decode_step from tokens 1..B: (fed tokens, chosen tokens, cache)."""
    cj, _, pj, _ = _models(shape)
    cache = JTF.init_cache(cj, B, T, kv_quant=kv_quant)
    t = jnp.arange(1, B + 1, dtype=jnp.int32)
    fed, chosen = [], []
    for _ in range(STEPS):
        logits, cache = JTF.decode_step(pj, cj, t, cache)
        fed.append(np.array(t))
        t = jnp.argmax(logits, -1).astype(jnp.int32)
        chosen.append(np.asarray(t))
    return fed, chosen, jax.tree.map(np.asarray, cache)


def _drive(step, params, cache, fed):
    out = []
    for t in fed:
        tok, cache = step(params, torch.as_tensor(t), cache)
        out.append(tok.numpy())
    return out, cache


def _assert_kv_close(got: dict, want: dict, quant: bool):
    if not quant:
        for k in ("k", "v"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-5)
        return
    for k in ("k", "v"):  # one int8 level
        assert np.abs(got[k].numpy().astype(np.int32) - want[k].astype(np.int32)).max() <= 1
    for k in ("k_scale", "v_scale"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=0)


# -- gpipe helpers ------------------------------------------------------------------


def _is_index(path):
    return str(path[-1]) == "index"


def test_gpipe_microbatch_slice_and_write():
    tree = {"k": torch.arange(24, dtype=torch.float32).reshape(2, 4, 3),
            "index": torch.tensor([5, 5], dtype=torch.int32)}
    orig = {k: v.clone() for k, v in tree.items()}
    sub = gpipe.microbatch_slice(tree, 1, 2, skip=_is_index)
    assert torch.equal(sub["k"], orig["k"][:, 2:4])
    assert torch.equal(sub["index"], orig["index"])  # passed whole
    sub["k"].fill_(7.0)
    sub["index"] += 1
    assert torch.equal(tree["k"], orig["k"]) and torch.equal(tree["index"], orig["index"])

    # the warm-up/drain bubble: inactive ticks keep the old rows
    new = {"k": torch.full((2, 2, 3), -1.0), "index": torch.tensor([9, 9], dtype=torch.int32)}
    gpipe.microbatch_write(tree, new, 1, 2, False, skip=_is_index)
    assert torch.equal(tree["k"], orig["k"])

    wrote = gpipe.microbatch_write(tree, new, 1, 2, True, skip=_is_index)
    assert wrote is tree
    assert torch.equal(tree["k"][:, 2:4], new["k"])
    assert torch.equal(tree["k"][:, :2], orig["k"][:, :2])
    assert torch.equal(tree["index"], orig["index"])  # skip wins


def test_rotate_keeps_bubble_rows_and_lockstep():
    """S=4 stages, 2S-1 ticks. Each stage adds s+1 and writes its input into
    its microgroup's cache rows (every tick, bubble included) and bumps a
    shared counter. Real rows hold exactly the active tick's input, the
    counter is untouched, and the output is the input plus 1+2+3+4 (a stage
    fed its neighbour's output of the same tick would add more)."""
    stages, mb, d = 4, 2, 3
    x_groups = torch.arange(stages * mb * d, dtype=torch.float32).reshape(stages, mb, 1, d)
    caches = [{"k": torch.full((1, stages * mb, d), -5.0),
               "index": torch.zeros((1,), dtype=torch.int32)} for _ in range(stages)]
    calls = []

    def apply_fn(s, x, sub):
        calls.append(s)
        sub["k"][0] = x[:, 0]
        sub["index"] += 1
        return x + (s + 1), sub

    xs = gpipe.rotate(
        x_groups, caches, stages=stages, apply_fn=apply_fn,
        slice_fn=lambda c, m: gpipe.microbatch_slice(c, m, mb, skip=_is_index),
        write_fn=lambda c, new, m, act: gpipe.microbatch_write(c, new, m, mb, act,
                                                               skip=_is_index),
        devices=[CPU] * stages)
    assert len(calls) == stages * (2 * stages - 1)  # every stage, every tick
    assert torch.equal(xs, x_groups[:, :, 0].reshape(stages * mb, d) + 10)
    for s, c in enumerate(caches):
        assert int(c["index"]) == 0
        want = x_groups[:, :, 0].reshape(stages * mb, d) + sum(range(1, s + 1))
        assert torch.equal(c["k"][0], want), s


def test_pipeline_entry_point_dispatch():
    ct = tcfg.get("whisper_base").reduced()
    mesh = LM.make_host_mesh((1, 1), device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        PL.build_pipeline_step(ct, mesh)
    with pytest.raises(ValueError, match="dense decoder-only"):
        PL.build_pipeline_step(ct, mesh, manual=True)
    llama = tcfg.get("llama32_1b").reduced()  # 2 groups
    with pytest.raises(ValueError, match="groups % 4 stages"):
        PL.build_pipeline_step(llama, LM.make_host_mesh((4, 1), device="cpu"))
    with pytest.raises(ValueError, match="groups % 4 stages"):
        PL.build_pipeline_step(llama, LM.make_host_mesh((4, 1), device="cpu"), manual=True)
    with pytest.raises(ValueError, match="% tp=3"):
        PL.build_pipeline_step(llama, LM.make_host_mesh((1, 3), device="cpu"), manual=True)
    with pytest.raises(ValueError, match="manual pipeline supports dense"):
        PL.build_pipeline_step(tcfg.get("dbrx_132b").reduced(),
                               LM.make_host_mesh((1, 1), device="cpu"), manual=True)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: LM.make_host_mesh(), lambda: LM.make_production_mesh(),
               lambda: PM.init_kv_cache(tcfg.get("llama32_1b").reduced(), 2, 8, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


# -- the auto variant ------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_auto_pipeline_matches_decode_step(mesh_shape, kv_quant):
    _, ct, _, pt = _models()
    fed, chosen, want = _reference(kv_quant)
    step = PL.build_pipeline_step(ct, LM.make_host_mesh(mesh_shape, device="cpu"))
    cache = TTF.init_cache(ct, B, T, kv_quant=kv_quant, device="cpu")
    got, cache = _drive(step, pt, cache, fed)
    for g, w in zip(got, chosen):
        np.testing.assert_array_equal(g, w)
    mix = cache["layer0"]["mixer"]
    _assert_kv_close(mix, want["layer0"]["mixer"], kv_quant)
    np.testing.assert_array_equal(mix["index"].numpy(), [STEPS] * ct.num_groups)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["plain", "int8"])
def test_bubble_ticks_keep_the_cache_at_four_stages(kv_quant):
    """S=4 (one group a stage): 7 ticks a step, 3 of them bubble for each
    stage. The cache equals the port's own decode_step cache (plain: 1e-5,
    int8: one level) and index advanced once a step."""
    _, ct, _, pt = _models()
    fed, _, _ = _reference(kv_quant)
    step = PL.build_pipeline_step(ct, LM.make_host_mesh((4, 1), device="cpu"))
    manual = PM.build_manual_pipeline_step(ct, LM.make_host_mesh((4, 1), device="cpu"))
    serve = ST.build_serve_step(ct)
    got = TTF.init_cache(ct, B, T, kv_quant=kv_quant, device="cpu")
    want = TTF.init_cache(ct, B, T, kv_quant=kv_quant, device="cpu")
    mcache = PM.init_kv_cache(ct, B, T, tp=1, device="cpu")
    qwant = TTF.init_cache(ct, B, T, kv_quant=True, device="cpu")
    for i, t in enumerate(fed):
        t = torch.as_tensor(t)
        step(pt, t, got)
        serve(pt, t, want)
        manual(pt, t, mcache)
        serve(pt, t, qwant)
        np.testing.assert_array_equal(got["layer0"]["mixer"]["index"].numpy(), [i + 1] * 4)
        np.testing.assert_array_equal(mcache["index"].numpy(), [i + 1] * 4)
    _assert_kv_close(got["layer0"]["mixer"],
                     {k: v.numpy() for k, v in want["layer0"]["mixer"].items()}, kv_quant)
    # at tp=1 the one rank keeps every KV head: the decode cache itself
    q = qwant["layer0"]["mixer"]
    _assert_kv_close(mcache, {k: q[k].numpy() for k in ("k", "v", "k_scale", "v_scale")}, True)


# -- the manual variant ------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape,axes", [
    ((2, 2), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model")),
], ids=["2x2", "pod2x2x2"])
def test_manual_pipeline_matches_decode_step(mesh_shape, axes):
    _, ct, _, pt = _models()
    fed, chosen, want = _reference(True)
    mesh = LM.make_host_mesh(mesh_shape, axes, device="cpu")
    tp = mesh.shape["model"]
    step = PL.build_pipeline_step(ct, mesh, manual=True)
    cache = PM.init_kv_cache(ct, B, T, tp=tp, device="cpu")
    got, cache = _drive(step, pt, cache, fed)
    for g, w in zip(got, chosen):
        np.testing.assert_array_equal(g, w)
    heads = PM.kv_heads(ct, tp)
    ref = want["layer0"]["mixer"]
    _assert_kv_close(cache, {k: ref[k][:, :, :, heads] for k in
                             ("k", "v", "k_scale", "v_scale")}, True)
    np.testing.assert_array_equal(cache["index"].numpy(), [STEPS] * ct.num_groups)


def test_manual_pipeline_keeps_every_kv_head_a_rank_needs():
    """8/4 heads at tp=2: each rank's 4 query heads span 2 KV heads. The
    reference keeps one a rank and its tokens leave decode_step's; the port
    keeps both and matches."""
    shape = tuple({**SHAPE, "num_heads": 8, "num_kv_heads": 4, "head_dim": 16}.items())
    _, ct, _, pt = _models(shape)
    fed, chosen, _ = _reference(True, shape)
    step = PL.build_pipeline_step(ct, LM.make_host_mesh((2, 2), device="cpu"), manual=True)
    cache = PM.init_kv_cache(ct, B, T, tp=2, device="cpu")
    assert PM.kv_per_rank(ct, 2) == 2 and cache["k"].shape[3] == 4
    got, _ = _drive(step, pt, cache, fed)
    for g, w in zip(got, chosen):
        np.testing.assert_array_equal(g, w)
