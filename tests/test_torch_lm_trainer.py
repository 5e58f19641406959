"""Slice D through the trainer: the port's ``LMCohortTrainer.run`` against the
reference's, from the reference's initial weights (assigned to the port's
trainer, optimizer state reset from them) on the same token streams; the
``sgd`` optimizer path; ``domain_metrics``; the ``compress`` rules.

Params tolerance: AdamW's first step moves each weight by about
``lr * sign(g)``, so a gradient component whose sign the two packages'
rounding flips would move a whole ``2 lr``. The tests count the elements
above 1e-5 and require none: over these runs the largest difference is a
few 1e-7 (f32 rounding of the per-node value-and-grad), no sign flips.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as ref_cfgbase
from repro.train import trainer as ref_trainer_mod
from repro_torch.configs import base as cfgbase
from repro_torch.convert import params_from_numpy
from repro_torch.core import compress as compress_mod
from repro_torch.optim import adamw, sgd
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.trainer import LMCohortTrainer
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


N = 4
TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
            vocab_size=256)


def _cfgs(**kw):
    return (dataclasses.replace(ref_cfgbase.get("llama32_1b").reduced(), **TINY, **kw),
            dataclasses.replace(cfgbase.get("llama32_1b").reduced(), **TINY, **kw))


def _pair(topology="ring:n=4", optimizer="adamw", **kw):
    """The reference's trainer, and the port's on its initial weights."""
    ref_cfg, cfg = _cfgs(optimizer=optimizer)
    kw = dict(nodes=N, batch=2, seq=16, lr=1e-3, **kw)
    ref = ref_trainer_mod.LMCohortTrainer(topology, ref_cfg, **kw)
    port = LMCohortTrainer(topology, cfg, device="cpu", **kw)
    port.params = params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu")
    port.opt_state = (adamw.init(port.params) if optimizer == "adamw"
                      else sgd.init(port.params))
    if port.cstate is not None:
        port.cstate = compress_mod.init(port.params)
    return ref, port


def _param_gap(ref, port):
    """(max abs difference, elements above 1e-5) over every leaf."""
    worst, above = 0.0, 0
    for w, g in zip(jax.tree.leaves(ref.params), tree_leaves(port.params), strict=True):
        d = np.abs(np.asarray(w, np.float32) - g.float().numpy())
        worst, above = max(worst, float(d.max())), above + int((d > 1e-5).sum())
    return worst, above


@pytest.mark.parametrize("topology", ["ring:n=4", "star:n=4"])
def test_run_matches_the_reference(topology):
    ref, port = _pair(topology)
    h_ref, h = ref.run(3), port.run(3)
    assert [r["round"] for r in h] == [r["round"] for r in h_ref] == [0, 1, 2]
    for a, b in zip(h, h_ref):
        assert set(a) == set(b)
        for key in ("loss", "lr", "g2_token_spread"):
            assert a[key] == pytest.approx(b[key], rel=0, abs=1e-5), key
        np.testing.assert_allclose(a["domain_acc"], b["domain_acc"], rtol=0, atol=1e-5)
    worst, above = _param_gap(ref, port)
    assert above == 0, f"{above} elements differ by more than 1e-5 (max {worst})"
    np.testing.assert_allclose(port.consensus(), ref.consensus(), rtol=1e-4, atol=1e-6)


def test_sgd_path_matches_the_reference():
    ref, port = _pair("ring:n=4", optimizer="sgd", schedule="const")
    h_ref, h = ref.run(3), port.run(3)
    for a, b in zip(h, h_ref):
        assert a["loss"] == pytest.approx(b["loss"], rel=0, abs=1e-5)
    worst, above = _param_gap(ref, port)
    assert above == 0 and worst <= 1e-5


def test_choco_loop_matches_the_reference():
    """compress=0.25 (CHOCO) on the loop: top-k per node and leaf, mixed
    references, residual. Top-k is discontinuous, and AdamW makes it
    touchy: its early steps are about ``lr`` in magnitude for most entries,
    so many |delta| sit within the packages' rounding of the k-th largest,
    and the two packages may send different ones; each such flip moves a
    whole entry, in the sender's reference and in its neighbours' params.
    So the references and params are held at 1e-5 except for at most 1
    element in 1,000 of a leaf (here 2 reference and 12 param entries of
    the widest leaf's 65,536), and the losses at 1e-5."""
    ref, port = _pair("ring:n=4", compress=0.25)
    h_ref, h = ref.run(2), port.run(2)
    for a, b in zip(h, h_ref):
        assert a["loss"] == pytest.approx(b["loss"], rel=0, abs=1e-5)
    for trees in ((ref.cstate.reference, port.cstate.reference), (ref.params, port.params)):
        for w, g in zip(jax.tree.leaves(trees[0]), tree_leaves(trees[1]), strict=True):
            d = np.abs(np.asarray(w) - g.numpy())
            assert int((d > 1e-5).sum()) <= d.size // 1000, (int((d > 1e-5).sum()), d.size)


def test_faulted_run_matches_the_reference():
    spec = "churn:p_leave=0.3,p_join=0.3;straggler:frac=0.3,delay=2"
    ref, port = _pair("ring:n=4", faults=spec)
    h_ref, h = ref.run(3), port.run(3)
    for a, b in zip(h, h_ref):
        assert a["alive_count"] == b["alive_count"]
        assert a["loss"] == pytest.approx(b["loss"], rel=0, abs=1e-5)
    assert _param_gap(ref, port)[1] == 0


def test_domain_metrics_match_the_reference():
    ref, port = _pair("star:n=4")
    for _ in range(2):
        got, want = port.domain_metrics(), ref.domain_metrics()
        np.testing.assert_allclose(got["domain_acc"], want["domain_acc"], rtol=0, atol=1e-5)
        assert got["g2_token_spread"] == pytest.approx(want["g2_token_spread"], abs=1e-5)
        ref.run(1), port.run(1)
    one = LMCohortTrainer("ring:n=1", _cfgs()[1], nodes=1, batch=2, seq=16, device="cpu")
    assert one.domain_metrics() == {}


class TestCompressRules:
    """compress='auto' thresholds on member bytes; faults never compose."""

    def _make(self, **kw):
        return LMCohortTrainer("ring:n=4", _cfgs()[1], nodes=N, batch=2, seq=16,
                               device="cpu", **kw)

    def test_small_member_stays_raw(self):
        t = self._make()
        assert t.member_bytes < trainer_mod._COMPRESS_AUTO_BYTES
        assert t.compress is None and t.cstate is None
        assert trainer_mod._COMPRESS_AUTO_BYTES == ref_trainer_mod._COMPRESS_AUTO_BYTES
        assert trainer_mod._COMPRESS_AUTO_K == ref_trainer_mod._COMPRESS_AUTO_K

    def test_large_member_compresses(self, monkeypatch):
        monkeypatch.setattr(trainer_mod, "_COMPRESS_AUTO_BYTES", 1024)
        t = self._make()
        assert t.compress == trainer_mod._COMPRESS_AUTO_K and t.cstate is not None
        assert all(r.dtype.is_floating_point and r.data_ptr() != p.data_ptr()
                   for r, p in zip(tree_leaves(t.cstate.reference), tree_leaves(t.params)))

    def test_auto_resolves_off_under_faults(self, monkeypatch):
        monkeypatch.setattr(trainer_mod, "_COMPRESS_AUTO_BYTES", 1024)
        assert self._make(faults="churn:p_leave=0.2,p_join=0.5").compress is None

    def test_explicit_compress_with_faults_raises(self):
        with pytest.raises(ValueError, match="faults do not compose"):
            self._make(compress=0.1, faults="churn:p_leave=0.2,p_join=0.5")

    @pytest.mark.parametrize("bad", [1.5, 0.0, -0.1])
    def test_bad_fraction_raises(self, bad):
        with pytest.raises(ValueError, match="top-k fraction"):
            self._make(compress=bad)

    def test_none_and_false_force_raw(self, monkeypatch):
        monkeypatch.setattr(trainer_mod, "_COMPRESS_AUTO_BYTES", 1024)
        assert self._make(compress=None).compress is None
        assert self._make(compress=False).compress is None

    def test_topology_pinning_other_n_raises(self):
        with pytest.raises(ValueError, match="pins n=6"):
            LMCohortTrainer("ring:n=6", _cfgs()[1], nodes=4, device="cpu")


def test_members_are_one_broadcast_init():
    t = LMCohortTrainer("ring:n=4", _cfgs()[1], nodes=N, batch=2, seq=16, device="cpu")
    for leaf in tree_leaves(t.params):
        assert leaf.is_contiguous() and leaf.shape[0] == N
        assert all(bool((leaf[i] == leaf[0]).all()) for i in range(N))
    assert t.member_params == sum(x[0].numel() for x in tree_leaves(t.params))
    assert t.opt_state.mu["embed"].dtype.is_floating_point
