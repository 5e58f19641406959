"""The port's sharded LLM cohort against the JAX reference.

In process, at ``test_torch_lm_trainer.py``'s size (4 members on a ring):
the port's ``sparse_sharded`` cohort over 2 shards of the CPU, started from
the reference's initial weights (assigned, and so scattered), against the
reference's ``sparse`` run over 3 rounds: plain, faulted, and CHOCO at the
fraction that file holds to the reference (0.25, with its allowance for
top-k near-ties). On 4 fake devices: one
subprocess of the reference (``tests/lm_sharded_reference.py``) runs its
``sparse_sharded`` cohort and asserts that its params, AdamW moments and
CHOCO references are laid out ``PartitionSpec('data')`` after ``run(2)``;
the port's sharded run from the same initial weights then matches its
params within 1e-5.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as ref_cfgbase
from repro.train import trainer as ref_trainer_mod
from repro_torch.configs import base as cfgbase
from repro_torch.core import compress as compress_mod
from repro_torch.core import mesh
from repro_torch.optim import adamw
from repro_torch.train.trainer import LMCohortTrainer
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
            vocab_size=256)
KW = dict(batch=2, seq=16, lr=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (dataclasses.replace(ref_cfgbase.get("llama32_1b").reduced(), **TINY),
            dataclasses.replace(cfgbase.get("llama32_1b").reduced(), **TINY))


def _sharded_port(cfg, params: list[np.ndarray], nodes: int, shards: int,
                  **kw) -> LMCohortTrainer:
    """The port's cohort of ``nodes`` on a ring over ``shards`` CPU shards,
    started from ``params`` (leaves in ``jax.tree.leaves`` order), its
    optimizer and CHOCO state reset from them, each assigned and so
    scattered."""
    port = LMCohortTrainer(f"ring:n={nodes}", cfg, nodes=nodes, backend="sparse_sharded",
                           mesh=mesh.Mesh([CPU] * shards, ("data",)), device="cpu", **KW, **kw)
    tree = port.params
    for x, p in zip(tree_leaves(tree), params, strict=True):
        x.copy_(torch.from_numpy(np.array(p)))
    port.params = tree
    port.opt_state = adamw.init(port.params)
    if port.cstate is not None:
        port.cstate = compress_mod.init(port.params)
    return port


def _gaps(ref_leaves, port_leaves, tol=1e-5):
    """(max abs difference, elements above ``tol``, their allowance of 1 in
    1,000 a leaf) over the leaves."""
    worst, above, allowed = 0.0, 0, 0
    for w, g in zip(ref_leaves, port_leaves, strict=True):
        d = np.abs(np.asarray(w, np.float32) - g.float().numpy())
        worst = max(worst, float(d.max()))
        above += int((d > tol).sum())
        allowed += d.size // 1000
    return worst, above, allowed


@pytest.mark.parametrize("mode", ["plain", "faulted", "choco"])
def test_sharded_cohort_stays_within_the_reference(mode):
    """Loss, lr and g2_token_spread within 1e-5, domain_acc within 1e-5,
    consensus rtol 1e-4, and no params element above 1e-5 (CHOCO: at most
    1 element in 1,000 of a leaf, as the unsharded CHOCO test allows)."""
    kw = {"plain": {}, "faulted": {"faults": "churn:p_leave=0.3,p_join=0.3;"
                                              "straggler:frac=0.3,delay=2"},
          "choco": {"compress": 0.25}}[mode]
    ref_cfg, cfg = _cfgs()
    ref = ref_trainer_mod.LMCohortTrainer("ring:n=4", ref_cfg, nodes=4, backend="sparse",
                                          **KW, **kw)
    port = _sharded_port(cfg, [np.asarray(x) for x in jax.tree.leaves(ref.params)], 4, 2, **kw)
    assert port.shards == 2 and all(x.shape[0] == 2 for x in tree_leaves(port._p[1]))
    h_ref, h = ref.run(3), port.run(3)
    assert [r["round"] for r in h] == [r["round"] for r in h_ref] == [0, 1, 2]
    for a, b in zip(h, h_ref):
        assert set(a) == set(b)
        for key in ("loss", "lr", "g2_token_spread"):
            assert a[key] == pytest.approx(b[key], rel=0, abs=1e-5), key
        np.testing.assert_allclose(a["domain_acc"], b["domain_acc"], rtol=0, atol=1e-5)
        assert a.get("alive_count") == b.get("alive_count")
    worst, above, allowed = _gaps(jax.tree.leaves(ref.params), tree_leaves(port.params))
    if mode == "choco":
        assert above <= allowed, (above, allowed, worst)
    else:
        assert above == 0, f"{above} elements differ by more than 1e-5 (max {worst})"
    np.testing.assert_allclose(port.consensus(), ref.consensus(), rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def ref_on_four_devices(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "lm_sharded.npz"
    r = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "lm_sharded_reference.py"), str(out)],
        capture_output=True, text=True, timeout=400,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
    )
    assert r.returncode == 0 and "OK" in r.stdout, (r.stdout[-2000:], r.stderr[-2000:])
    return dict(np.load(out))


def test_the_reference_shards_its_cohort_and_the_port_matches_it(ref_on_four_devices):
    """The reference's sparse_sharded cohort on 4 devices keeps its state
    at PartitionSpec('data') (asserted in the subprocess); the port's
    sharded cohort from its initial weights, on 4 shards, ends within 1e-5
    of its params after run(2), with the same losses within 1e-5."""
    data = ref_on_four_devices
    count = len([k for k in data if k.startswith("init/")])
    _, cfg = _cfgs()
    port = _sharded_port(cfg, [data[f"init/{i}"] for i in range(count)], 8, 4, compress=1.0)
    hist = port.run(2)
    np.testing.assert_allclose([r["loss"] for r in hist], data["losses"], rtol=0, atol=1e-5)
    worst, above, _ = _gaps([data[f"final/{i}"] for i in range(count)], tree_leaves(port.params))
    assert above == 0, f"{above} elements differ by more than 1e-5 (max {worst})"
