"""The port's LLM configs, layers and flash-attention plain version against
the JAX reference, on the same numpy inputs and weights (f32, reduced sizes,
the CPU).

Layers hold 1e-5; the flash plain version holds the Pallas kernel (interpret
mode, as the reference's own tests run it) to 3e-5 in f32 and 3e-2 in bf16,
the reference's kernel tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro_torch.configs import base as tcfg
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL

ARCHS = ["llama32_1b", "stablelm_3b", "minicpm_2b", "mistral_large_123b"]
TOL = dict(rtol=1e-5, atol=1e-5)
# The port's own config fields, which the reference lacks: every config of
# the reference's zoo leaves them at their defaults.
PORT_ONLY = {"use_rope": True, "tie_embeddings": False, "norm_eps": 1e-5}
PORT_ONLY_MAMBA = {"inner_norms": False}


def _reference_fields(ct) -> list[str]:
    """The port config's field names but its own, each of which must be at
    its default."""
    for name, default in PORT_ONLY.items():
        assert getattr(ct, name) == default, name
    return [f.name for f in dataclasses.fields(ct) if f.name not in PORT_ONLY]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_mirrors_the_reference_field_for_field(arch, reduced):
    cj, ct = jcfg.get(arch), tcfg.get(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    names = [f.name for f in dataclasses.fields(cj)]
    assert names == _reference_fields(ct)
    for name in names:
        a, b = getattr(cj, name), getattr(ct, name)
        if name == "pattern":
            a, b = [(s.mixer, s.ffn) for s in a], [(s.mixer, s.ffn) for s in b]
        assert a == b, name
    assert (cj.hd, cj.period, cj.num_groups) == (ct.hd, ct.period, ct.num_groups)
    assert ct.dtype() == getattr(torch, jnp.dtype(cj.dtype()).name)


def test_config_aliases_and_the_paper_mlp():
    assert tcfg.get("llama3.2-1b") is tcfg.get("llama32_1b")
    assert tcfg.get("mistral-large-123b").hd == 128
    assert dataclasses.asdict(tcfg.get("paper-mlp")) == dataclasses.asdict(jcfg.get("paper-mlp"))
    with pytest.raises(ValueError, match="unknown arch"):
        tcfg.get("no-such-arch")


@pytest.mark.parametrize(
    "arch", ["jamba-v0.1-52b", "dbrx-132b", "arctic-480b", "rwkv6-3b", "whisper-base",
             "internvl2-76b"])
def test_archs_not_ported_raise_naming_their_slice(arch):
    """The zoo archs beyond the dense four: each resolves, and mirrors the
    reference field for field, its MoE / Mamba / RWKV spec dataclass
    included, in full and reduced."""
    for cj, ct in ((jcfg.get(arch), tcfg.get(arch)),
                   (jcfg.get(arch).reduced(), tcfg.get(arch).reduced())):
        names = [f.name for f in dataclasses.fields(cj)]
        assert names == _reference_fields(ct)
        for name in names:
            a, b = getattr(cj, name), getattr(ct, name)
            if name == "pattern":
                a, b = [(s.mixer, s.ffn) for s in a], [(s.mixer, s.ffn) for s in b]
            elif name in ("moe", "mamba", "rwkv") and a is not None:
                assert type(a).__name__ == type(b).__name__, name
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                for key, default in (PORT_ONLY_MAMBA.items() if name == "mamba" else ()):
                    assert b.pop(key) == default, key
            assert a == b, name
        assert (cj.hd, cj.period, cj.num_groups) == (ct.hd, ct.period, ct.num_groups)
    assert tcfg.get(arch) is tcfg.get(arch.replace("-", "_").replace(".", ""))
    assert arch.replace("-", "_").replace(".", "") in tcfg.all_arch_ids()


# -- norms, rope, FFNs -----------------------------------------------------------


def test_norms_rope_and_ffns_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(w)), JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(TL.layer_norm(_t(x), _t(w), _t(b)),
           JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    _close(TL.norm(_t(x), {"w": _t(w), "b": _t(b)}, "ln"),
           JL.norm(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)}, "ln"))
    _close(TL.rope_freqs(32, 500_000.0), JL.rope_freqs(32, 500_000.0))
    pos1 = np.arange(3, 10)
    pos2 = rng.integers(0, 300, (2, 7))
    for pos in (pos1, pos2):
        _close(TL.apply_rope(_t(x), _t(pos), 10_000.0),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    ffn = jax.tree.map(np.asarray, JL.init_ffn(jax.random.PRNGKey(0), 32, 64, jnp.float32))
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    pt = params_from_numpy(ffn, "cpu")
    _close(TL.swiglu_ffn(pt, _t(h)), JL.swiglu_ffn(ffn, jnp.asarray(h)))
    _close(TL.gelu_ffn(pt, _t(h)), JL.gelu_ffn(ffn, jnp.asarray(h)))


def test_quant_kv_matches_bit_for_bit():
    x = np.random.default_rng(1).standard_normal((2, 9, 2, 32)).astype(np.float32) * 3
    qt, st = TL._quant_kv(_t(x))
    qj, sj = JL._quant_kv(jnp.asarray(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    _close(st, sj)


# -- attention cores -------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_and_chunked_attention_match(causal, window):
    """The chunked loop with 16-wide chunks over S = T = 40 runs 3 query
    chunks and 3 KV chunks, both padded. Not causal, the reference's chunked
    loop attends the zero-padded keys (ROADMAP queue 3); the port's masks
    them, so there it is held to the reference's dense attention."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    args_j = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    args_t = [_t(a) for a in (q, k, v, pos, pos)]
    kw = dict(causal=causal, window=window)
    want = JL.dense_attention(*args_j, **kw)
    _close(TL.dense_attention(*args_t, **kw), want)
    _close(TL.chunked_attention(*args_t, kv_chunk=16, q_chunk=16, **kw), want)
    # the dispatch: above the threshold it takes the chunked loop
    _close(TL.attention(*args_t, kv_chunk=16, dense_threshold=0, **kw), want)
    if causal:
        _close(TL.chunked_attention(*args_t, kv_chunk=16, q_chunk=16, **kw),
               JL.chunked_attention(*args_j, kv_chunk=16, q_chunk=16, **kw))
        _close(TL.attention(*args_t, kv_chunk=16, dense_threshold=0, **kw),
               JL.attention(*args_j, kv_chunk=16, dense_threshold=0, **kw))


# -- attention_layer in each mode ------------------------------------------------

B, D, H, HKV, HD, T = 2, 64, 4, 2, 32, 16


def _attn_params():
    spec = JL.AttnSpec(num_heads=H, num_kv_heads=HKV, head_dim=HD)
    p = jax.tree.map(np.asarray, JL.init_attention(jax.random.PRNGKey(3), D, spec, jnp.float32))
    return p, params_from_numpy(p, "cpu")


def _cache(kind: str, index):
    """A (B, T, HKV, HD) cache as numpy: zeros, or random rows for decode."""
    rng = np.random.default_rng(4)
    shape = (B, T, HKV, HD)
    if kind == "int8":
        c = {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8),
             "k_scale": np.zeros(shape[:-1] + (1,), np.float32),
             "v_scale": np.zeros(shape[:-1] + (1,), np.float32)}
    elif kind == "random":
        c = {"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32)}
    else:
        c = {"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32)}
    c["index"] = np.asarray(index, np.int32)
    return c


MODES = {
    # name: (S, AttnSpec kwargs, cache kind or None, index, decode steps after)
    "full": (11, {}, None, 0, 0),
    "full_window": (11, {"window": 5}, None, 0, 0),
    "prefill_s_le_t": (12, {}, "zeros", 0, 3),
    "prefill_ring_s_gt_t": (24, {}, "zeros", 0, 3),
    "decode_scalar_index": (1, {}, "random", 9, 2),
    "decode_per_slot_index": (1, {}, "random", [3, 14], 3),
    "decode_per_slot_past_ring": (1, {}, "random", [17, 40], 2),
    "int8_prefill_and_decode": (10, {}, "int8", 0, 3),
    "window_prefill_and_decode": (12, {"window": 8}, "zeros", 0, 4),
    "window_ring": (20, {"window": 8}, "zeros", 0, 4),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_attention_layer_matches_in_every_mode(mode):
    s, spec_kw, kind, index, steps = MODES[mode]
    pj, pt = _attn_params()
    spec_j = JL.AttnSpec(num_heads=H, num_kv_heads=HKV, head_dim=HD, rope_theta=10_000.0, **spec_kw)
    spec_t = TL.AttnSpec(num_heads=H, num_kv_heads=HKV, head_dim=HD, rope_theta=10_000.0, **spec_kw)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, s, D)).astype(np.float32)
    cj = None if kind is None else jax.tree.map(jnp.asarray, _cache(kind, index))
    ct = None if kind is None else params_from_numpy(_cache(kind, index), "cpu")
    yj, cj = JL.attention_layer(pj, jnp.asarray(x), spec_j, cache=cj)
    yt, ct = TL.attention_layer(pt, _t(x), spec_t, cache=ct)
    _close(yt, yj)
    for _ in range(steps):
        x1 = rng.standard_normal((B, 1, D)).astype(np.float32)
        yj, cj = JL.attention_layer(pj, jnp.asarray(x1), spec_j, cache=cj)
        yt, ct = TL.attention_layer(pt, _t(x1), spec_t, cache=ct)
        _close(yt, yj)
    if kind is not None:
        assert sorted(ct) == sorted(cj)
        for key in cj:
            _close(ct[key], cj[key])


def test_attention_layer_cross_attention_matches():
    pj, pt = _attn_params()
    spec_j = JL.AttnSpec(num_heads=H, num_kv_heads=HKV, head_dim=HD)
    spec_t = TL.AttnSpec(num_heads=H, num_kv_heads=HKV, head_dim=HD)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 7, D)).astype(np.float32)
    mk, mv = (rng.standard_normal((B, 13, HKV, HD)).astype(np.float32) for _ in range(2))
    yj, _ = JL.attention_layer(pj, jnp.asarray(x), spec_j, cross_kv=(jnp.asarray(mk), jnp.asarray(mv)))
    yt, none = TL.attention_layer(pt, _t(x), spec_t, cross_kv=(_t(mk), _t(mv)))
    assert none is None
    _close(yt, yj)


def test_prefill_flash_flag_takes_the_kernel_wrapper(monkeypatch):
    """spec.flash routes prefill through ops.flash_attention: on CPU tensors
    its plain version, which launches nothing."""
    pj, pt = _attn_params()
    spec_j = JL.AttnSpec(num_heads=H, num_kv_heads=HKV, head_dim=HD, flash=True)
    spec_t = TL.AttnSpec(num_heads=H, num_kv_heads=HKV, head_dim=HD, flash=True)
    x = np.random.default_rng(7).standard_normal((B, 16, D)).astype(np.float32)
    calls = []
    real = tops.flash_attention
    monkeypatch.setattr(tops, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    reset_launches()
    yt, _ = TL.attention_layer(pt, _t(x), spec_t, cache=params_from_numpy(_cache("zeros", 0), "cpu"))
    assert calls == [1] and LAUNCHES["flash_attention"] == 0
    yj, _ = JL.attention_layer(pj, jnp.asarray(x), spec_j,
                               cache=jax.tree.map(jnp.asarray, _cache("zeros", 0)))
    _close(yt, yj, dict(rtol=3e-5, atol=3e-5))


# -- flash attention: the plain version against the Pallas kernel ----------------


@pytest.mark.parametrize(
    "b,s,h,hkv,hd,window",
    [
        (1, 64, 4, 2, 32, None),
        (2, 100, 8, 2, 32, None),  # ragged: the Pallas wrapper pads, the port masks
        (1, 128, 4, 4, 64, 48),  # MHA + sliding window
        (1, 96, 8, 1, 32, 16),  # MQA + tight window
    ],
)
def test_flash_plain_version_matches_the_pallas_kernel(b, s, h, hkv, hd, window):
    rng = np.random.default_rng(s * 7 + h)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                window=window, bq=32, bk=32, interpret=True)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    _close(got, want, dict(rtol=3e-5, atol=3e-5))


def test_flash_plain_version_matches_the_pallas_kernel_bf16():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 64, n, 32)).astype(np.float32) for n in (4, 2, 2))
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jops.flash_attention(qj, kj, vj, bq=32, bk=32, interpret=True)
    qt, kt, vt = params_from_numpy([np.asarray(a) for a in (qj, kj, vj)], "cpu")
    got = tfa.flash_attention(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), dict(rtol=3e-2, atol=3e-2))


def test_flash_plain_version_gives_zero_for_a_query_with_no_key():
    """A window with S > T leaves late queries nothing to attend: 0, not nan."""
    q = torch.randn(1, 8, 2, 32)
    k = v = torch.randn(1, 4, 2, 32)
    out = tfa.flash_attention(q, k, v, window=2)
    assert torch.isfinite(out).all() and (out[:, 5:] == 0).all()


def test_convert_round_trips_bf16_bit_for_bit():
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (3, 5)).astype(jnp.bfloat16))
    t = params_from_numpy({"x": [a, None]}, "cpu")
    assert t["x"][0].dtype == torch.bfloat16 and t["x"][1] is None
    back = params_to_numpy(t)["x"][0]
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back.view(np.uint16), a.view(np.uint16))
