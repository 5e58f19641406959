"""AI21-Jamba2-3B in the port (``configs/jamba2_3b.py``): the reduced member
against the plain reference ``tests/jamba_reference.py`` on seeded weights,
the full-width tree on the ``meta`` device, the selective scan's plain
version against the mixer's formulas as they stood before it, and jamba-v0.1
unchanged by the new config fields at their defaults. One intra-op thread,
the CPU, no JAX.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

import jamba_reference as R
from repro_torch.configs import base as cfgbase
from repro_torch.configs import jamba2_3b
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.models import mamba as Mb
from repro_torch.models import transformer as TF
from repro_torch.tree import tree_leaves, tree_unflatten

# The published config's counts (layers of 2560, d_inner 5120, d_state 16,
# dt_rank 160, 20 query heads and 1 KV head of 128, FFN 8192, vocab 65,536).
MAMBA_MIXER = (2560 * 10240 + 4 * 5120 + 5120 + 5120 * (160 + 32) + 160 * 5120 + 5120
               + 5120 * 16 + 5120 + 5120 * 2560 + 160 + 16 + 16)
ATTENTION = 2560 * 2560 + 2 * 2560 * 128 + 2560 * 2560
FFN = 3 * 2560 * 8192
EMBED = 65536 * 2560


def _published_count(layers: int) -> int:
    attn = layers // 14
    return ((layers - attn) * MAMBA_MIXER + attn * ATTENTION + layers * FFN + EMBED
            + (2 * layers + 1) * 2560)


@pytest.fixture(autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _seeded(cfg, seed=0):
    """The member's init with every leaf moved off its constant (norm
    weights of one, zero biases), so each leaf's use shows."""
    params = TF.init_params(seed, cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    return tree_unflatten(params, [x + 0.05 * torch.randn(x.shape, generator=gen).to(x.dtype)
                                   for x in tree_leaves(params)])


def _tokens(cfg, b=2, s=40, seed=2):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randint(0, cfg.vocab_size, (b, s), generator=gen),
            torch.randint(0, cfg.vocab_size, (b, s), generator=gen))


def test_the_config_is_the_published_block_cut_to_one_period():
    cfg = cfgbase.get("jamba2-3b")
    assert cfg is cfgbase.get("jamba2_3b") and "jamba2_3b" not in cfgbase.all_arch_ids()
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size) == (
        2560, 20, 1, 128, 8192, 65536)
    assert cfg.num_layers == 14 and jamba2_3b.PUBLISHED_LAYERS == 28
    assert [s.mixer for s in cfg.pattern] == ["mamba"] * 7 + ["attn"] + ["mamba"] * 6
    assert all(s.ffn == "dense" for s in cfg.pattern)
    m = cfg.mamba
    assert (m.d_state, m.d_conv, m.expand, m.rank(cfg.d_model), m.inner_norms) == (
        16, 4, 2, 160, True)
    assert (cfg.use_rope, cfg.tie_embeddings, cfg.norm_eps, cfg.optimizer, cfg.param_dtype) == (
        False, True, 1e-6, "sgd", "bfloat16")


@pytest.mark.parametrize("layers", [14, 28])
def test_full_width_parameter_count_on_meta(layers):
    cfg = dataclasses.replace(cfgbase.get("jamba2-3b"), num_layers=layers)
    params = TF.init_params(0, cfg, device="meta")
    assert TF.param_count(params) == _published_count(layers)
    assert _published_count(14) == 1_598_556_096 and _published_count(28) == 3_029_337_472
    assert "lm_head" not in params  # tied: gossip mixes one embedding leaf
    mixer = params["blocks"]["layer0"]["mamba"]
    assert {k: tuple(mixer[k].shape) for k in ("dt_norm", "b_norm", "c_norm")} == {
        "dt_norm": (layers // 14, 160), "b_norm": (layers // 14, 16), "c_norm": (layers // 14, 16)}
    assert mixer["a_log"].dtype == torch.float32 and mixer["in_proj"].dtype == torch.bfloat16


def test_reduced_member_matches_the_reference_forward_loss_and_grads():
    """One period of 14 (attention at 7), tied embeddings, no RoPE, the inner
    norms and one KV head, f32. Logits within 5e-5 of the reference's: the
    port's in-chunk scan is log-depth, the reference's sequential, and 14
    layers compound their roundings; the loss within 1e-5 (a mean over the
    same logits); each leaf's gradient within 1e-4 of its largest entry."""
    cfg = cfgbase.get("jamba2-3b").reduced()
    assert (cfg.num_layers, cfg.num_kv_heads, cfg.tie_embeddings, cfg.use_rope) == (
        14, 1, True, False)
    assert cfg.mamba.inner_norms and cfg.param_dtype == "float32"
    params = _seeded(cfg)
    toks, labels = _tokens(cfg)
    logits, _ = TF.forward(params, cfg, toks)
    want = R.forward_logits(params, cfg, toks)
    torch.testing.assert_close(logits, want, rtol=0, atol=5e-5)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss = ST.node_loss_fn(cfg)(tree_unflatten(params, leaves), {"tokens": toks, "labels": labels})
    grads = torch.autograd.grad(loss, leaves)
    ref_loss, ref_grads = R.loss_and_grads(params, cfg, toks, labels)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5
    for got, want in zip(grads, tree_leaves(ref_grads)):
        scale = float(want.abs().max())
        assert scale > 0
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("feature", ["inner_norms", "use_rope", "tie_embeddings", "norm_eps"])
def test_each_new_field_changes_the_member(feature):
    """The reference is the published block: turning any one field back to
    the zoo's default moves the port's logits away from it."""
    cfg = cfgbase.get("jamba2-3b").reduced()
    params = _seeded(cfg)
    toks, _ = _tokens(cfg)
    want = R.forward_logits(params, cfg, toks)
    if feature == "inner_norms":
        other = dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba, inner_norms=False))
    elif feature == "norm_eps":
        other = dataclasses.replace(cfg, norm_eps=1.0)  # 1e-5 moves it below the test's reach
    else:
        other = dataclasses.replace(cfg, **{feature: not getattr(cfg, feature)})
    p = params
    if feature == "tie_embeddings":
        p = {**params, "lm_head": params["embed"].T.contiguous() * 1.5}
    logits, _ = TF.forward(p, other, toks)
    assert float((logits - want).abs().max()) > 1e-2


def _old_mixer_scan(xs, dt, dt_bias, a, bmat, cmat, d_skip, h0, chunk):
    """The Mamba mixer's scan as ``mamba_block`` wrote it before the scan
    became ``ops.selective_scan``, formula for formula."""
    dt = F.softplus(dt + dt_bias)
    a_bar = torch.exp(dt[..., None] * a[None, None])
    bx = (dt[..., None] * bmat[:, :, None, :]) * xs.float()[..., None]
    y, h_last = Mb._ssm_chunked(a_bar, bx, cmat, h0, chunk)
    return y + d_skip[None, None] * xs.float(), h_last


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk,with_h0", [(29, 8, False), (64, 16, True), (5, 256, False)])
def test_plain_selective_scan_is_the_old_path_bit_for_bit(dtype, s, chunk, with_h0):
    gen = torch.Generator().manual_seed(s)
    b, di, n = 2, 24, 8
    xs = torch.randn(b, s, di, generator=gen).to(dtype)
    dt = torch.randn(b, s, di, generator=gen)
    dt_bias = torch.full((di,), -2.0)
    a = -torch.exp(torch.log(torch.arange(1, n + 1, dtype=torch.float32))).expand(di, n)
    bmat, cmat = (torch.randn(b, s, n, generator=gen) for _ in range(2))
    d_skip = torch.randn(di, generator=gen)
    h0 = torch.randn(b, di, n, generator=gen) if with_h0 else None
    ins = [xs, dt, dt_bias, a.contiguous(), bmat, cmat, d_skip]
    got_in = [x.clone().requires_grad_(True) for x in ins]
    old_in = [x.clone().requires_grad_(True) for x in ins]
    y, h = ops.selective_scan(*got_in, h0, chunk=chunk)
    zero = torch.zeros(b, di, n)
    y0, h_0 = _old_mixer_scan(*old_in, zero if h0 is None else h0, chunk)
    assert torch.equal(y, y0) and torch.equal(h, h_0)
    (y.sum() + h.sum()).backward()
    (y0.sum() + h_0.sum()).backward()
    for p, q in zip(got_in, old_in):
        assert torch.equal(p.grad, q.grad)


def test_selective_scan_refuses_what_it_does_not_take():
    x = torch.zeros(1, 4, 3)
    a, bm = torch.zeros(3, 2), torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="do not fit"):
        ops.selective_scan(x, torch.zeros(1, 5, 3), torch.zeros(3), a, bm, bm, torch.zeros(3))
    with pytest.raises(TypeError, match="f32"):
        ops.selective_scan(x, x.double(), torch.zeros(3), a, bm, bm, torch.zeros(3))
    m = torch.zeros(1, 4, 3, device="meta")  # the dry-run's shapes, through the plain version
    y, h = ops.selective_scan(m, m, torch.zeros(3, device="meta"), a.to("meta"), bm.to("meta"),
                              bm.to("meta"), torch.zeros(3, device="meta"))
    assert (y.shape, h.shape, y.device.type) == ((1, 4, 3), (1, 3, 2), "meta")


def test_defaults_keep_jamba_v01_as_it_was():
    """jamba-v0.1 leaves every new field at its default: the same tree (an
    ``lm_head``, no inner-norm leaves), and its mixer's output and gradients
    are the old formulas' bit for bit (the scan routed through the op)."""
    cfg = cfgbase.get("jamba-v0.1-52b")
    assert (cfg.use_rope, cfg.tie_embeddings, cfg.norm_eps, cfg.mamba.inner_norms) == (
        True, False, 1e-5, False)
    full = TF.init_params(0, cfg, device="meta")
    assert "lm_head" in full and "dt_norm" not in full["blocks"]["layer0"]["mamba"]
    red = cfg.reduced()
    spec = red.mamba
    params = Mb.init_mamba(torch.Generator().manual_seed(0), red.d_model, spec, torch.float32)
    x = torch.randn(2, 19, red.d_model, generator=torch.Generator().manual_seed(3))
    got = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    y, _ = Mb.mamba_block(got, x, spec)
    old = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xz = x @ old["in_proj"]
    xs, z = xz.chunk(2, dim=-1)
    xs, _ = Mb._causal_conv(xs, old["conv_w"], old["conv_b"], None)
    xs = F.silu(xs)
    dt, bmat, cmat = (xs @ old["x_proj"]).float().split(
        [spec.rank(red.d_model), spec.d_state, spec.d_state], dim=-1)
    yo, _ = _old_mixer_scan(xs, dt @ old["dt_proj"].float(), old["dt_bias"],
                            -torch.exp(old["a_log"]), bmat, cmat, old["d_skip"],
                            torch.zeros(2, spec.inner(red.d_model), spec.d_state), spec.chunk)
    yo = ((yo.to(x.dtype) * F.silu(z)) @ old["out_proj"]).to(x.dtype)
    assert torch.equal(y, yo)
    y.square().sum().backward()
    yo.square().sum().backward()
    assert all(torch.equal(got[k].grad, old[k].grad) for k in params)
