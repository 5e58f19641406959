"""Training the zoo in the port against the JAX reference (reduced configs,
f32, the CPU): ``node_loss_fn``'s loss and gradients at 1e-5, enc-dec
(frames) and VLM (prefix) batches included; ``LMCohortTrainer.run`` against
the reference's over 3 rounds for a reduced jamba (SGD, Mamba + MoE) and a
reduced rwkv6 (AdamW), from the reference's initial weights (no parameter
off by more than 1e-5); the port's fused path against its loop at 1e-6;
``launch.train --arch`` for every decoder-only zoo arch with ``--device
cpu``; and an enc-dec cohort refused, as the reference's fails.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.launch import steps as jsteps
from repro.models import transformer as JTF
from repro.train import trainer as jtrainer
from repro_torch.configs import base as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as train_cli
from repro_torch.optim import adamw, sgd
from repro_torch.train.trainer import LMCohortTrainer, _unflatten
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)


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


def _batch(cfg, arch: str) -> dict:
    """One node's (B=2) batch as numpy, with the arch's stub inputs: frames
    for enc-dec, a 4-embedding prefix (labels over prefix + tokens) for the
    VLM."""
    rng = np.random.default_rng(7)
    s = 12
    out = {"tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)}
    if cfg.enc_dec:
        out["frames"] = (rng.standard_normal((2, 10, cfg.d_model)) * 0.05).astype(np.float32)
    if arch == "internvl2_76b":
        out["prefix_embeds"] = (rng.standard_normal((2, 4, cfg.d_model)) * 0.05).astype(
            np.float32)
        out["labels"] = rng.integers(0, cfg.vocab_size, (2, s + 4)).astype(np.int32)
    return out


@pytest.mark.parametrize("arch", ["whisper_base", "internvl2_76b", "jamba_v01_52b",
                                  "rwkv6_3b", "dbrx_132b"])
def test_node_loss_and_grads_match(arch):
    cj, ct, pj, pt = _models(arch)
    batch = _batch(cj, arch)
    loss_j, grads_j = jax.value_and_grad(jsteps.node_loss_fn(cj))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(pt)]
    loss_t = tsteps.node_loss_fn(ct)(_unflatten(pt, leaves),
                                     {k: torch.from_numpy(v) for k, v in batch.items()})
    grads_t = torch.autograd.grad(loss_t, leaves, allow_unused=True, materialize_grads=True)
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=0, abs=1e-5)
    gj = jax.tree.leaves(grads_j)
    assert len(gj) == len(grads_t)
    for a, b in zip(grads_t, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _pair(arch: str, topology="ring:n=4"):
    """The reference's trainer, and the port's on its initial weights
    (compress off: CHOCO's top-k near-ties would flip whole entries)."""
    cj, ct = jcfg.get(arch).reduced(), tcfg.get(arch).reduced()
    kw = dict(nodes=4, batch=2, seq=16, lr=1e-3, compress=None)
    ref = jtrainer.LMCohortTrainer(topology, cj, **kw)
    port = LMCohortTrainer(topology, ct, device="cpu", **kw)
    port.params = params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu")
    port.opt_state = (adamw.init(port.params) if ct.optimizer == "adamw"
                      else sgd.init(port.params))
    return ref, port


@pytest.mark.parametrize("arch", ["jamba_v01_52b", "rwkv6_3b"])
def test_cohort_run_matches_the_reference(arch):
    ref, port = _pair(arch)
    assert port.cfg.optimizer == {"jamba_v01_52b": "sgd", "rwkv6_3b": "adamw"}[arch]
    h_ref, h = ref.run(3), port.run(3)
    assert [r["round"] for r in h] == [r["round"] for r in h_ref] == [0, 1, 2]
    for a, b in zip(h, h_ref):
        for key in ("loss", "lr", "g2_token_spread"):
            assert a[key] == pytest.approx(b[key], rel=0, abs=1e-5), key
    worst, above = 0.0, 0
    for w, g in zip(jax.tree.leaves(ref.params), tree_leaves(port.params), strict=True):
        d = np.abs(np.asarray(w, np.float32) - g.numpy())
        worst, above = max(worst, float(d.max())), above + int((d > 1e-5).sum())
    assert above == 0, f"{above} elements differ by more than 1e-5 (max {worst})"


@pytest.mark.parametrize("arch", ["internvl2_76b", "arctic_480b", "rwkv6_3b"])
def test_cohort_fused_matches_the_loop(arch):
    """run_fused (on the CPU: the same pieces, staged) against run at 1e-6,
    on sparse_pallas. Compress off: on CPU tensors the loop's mix and the
    staged program's sum in different orders, and CHOCO's top-k turns
    such last-bit differences into whole entries (on the card both run the
    blocked kernel)."""
    cfg = tcfg.get(arch).reduced()
    kw = dict(nodes=4, batch=2, seq=16, lr=1e-3, backend="sparse_pallas", device="cpu",
              compress=None)
    loop = LMCohortTrainer("ring:n=4", cfg, **kw)
    fused = LMCohortTrainer("ring:n=4", cfg, **kw)
    h_loop, h_fused = loop.run(3, eval_every=3), fused.run_fused(3, eval_every=3)
    assert h_loop[-1]["loss"] == pytest.approx(h_fused[-1]["loss"], rel=0, abs=1e-6)
    for a, b in zip(tree_leaves(loop.params), tree_leaves(fused.params), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_enc_dec_cohort_is_refused_as_the_reference_fails():
    """An LM cohort's batches carry tokens only. The reference's whisper
    cohort stops at its first step for want of encoder frames; the port
    refuses the member when the trainer is built."""
    kw = dict(nodes=4, batch=2, seq=16, lr=1e-3, compress=None)
    ref = jtrainer.LMCohortTrainer("ring:n=4", jcfg.get("whisper_base").reduced(), **kw)
    with pytest.raises(KeyError, match="frames"):
        ref.run(1)
    with pytest.raises(ValueError, match="encoder-decoder"):
        LMCohortTrainer("ring:n=4", tcfg.get("whisper_base").reduced(), device="cpu", **kw)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "dbrx-132b", "arctic-480b", "rwkv6-3b",
                                  "internvl2-76b"])
def test_train_cli_trains_every_zoo_arch_on_the_cpu(arch, tmp_path, capsys):
    result = train_cli.main(["--arch", arch, "--steps", "2", "--nodes", "4", "--batch", "2",
                             "--seq", "16", "--mix-backend", "sparse_pallas", "--device", "cpu",
                             "--store", str(tmp_path / "t.jsonl")])
    final = result["final"]
    assert final["fused"] is True and np.isfinite(final["loss"])
    out = capsys.readouterr().out
    assert "kernel launches" in out and "done in" in out


def test_train_cli_refuses_an_enc_dec_arch(tmp_path):
    with pytest.raises(ValueError, match="whisper-base-reduced is an encoder-decoder"):
        train_cli.main(["--arch", "whisper-base", "--steps", "2", "--nodes", "4",
                        "--device", "cpu", "--store", str(tmp_path / "t.jsonl")])
