"""The port's pipeline decoders against the JAX reference's own pipelines,
run in a subprocess on 8 fake CPU devices (``tests/pipeline_reference.py``).

The reduced llama in the reference test's shape: the auto variant on meshes
(2, 2) and (4, 1) with the plain and the int8 cache, the manual variant on
(2, 2) and (pod 2, 2, 2). Fed the tokens the reference's pipeline was fed,
the port chooses the same tokens; plain caches within 1e-5, int8 caches
within one quantization level (scales 1e-5 relative). With pods the
reference's cache is pod 0's copy (each pod writes its rows at the top of
its own replica), so only pod 0's rows are compared there. The same holds
for runs on trees placed once (``serve.pipeline.place``), their cache
gathered back (``launch.sharding.global_view``).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import requires_axis_type

from repro.configs import base as jcfg
from repro.models import transformer as JTF
from repro_torch.configs import base as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.launch import mesh as LM
from repro_torch.launch import sharding as SR
from repro_torch.models import transformer as TTF
from repro_torch.serve import pipeline as PL
from repro_torch.serve import pipeline_manual as PM
from repro_torch.tree import tree_map_with_path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32, d_model=128,
             d_ff=256, vocab_size=512)
B, T = 4, 16

pytestmark = requires_axis_type


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "llama.npz"
    r = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "pipeline_reference.py"), str(out), "llama"],
        capture_output=True, text=True, timeout=400,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
    )
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def model():
    cj = dataclasses.replace(jcfg.get("llama32_1b").reduced(), **SHAPE)
    ct = dataclasses.replace(tcfg.get("llama32_1b").reduced(), **SHAPE)
    pj = JTF.init_params(jax.random.PRNGKey(0), cj)
    return ct, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


def _drive(step, params, cache, fed):
    chosen = []
    for t in fed:
        tok, cache = step(params, torch.as_tensor(np.array(t)), cache)
        chosen.append(tok.numpy())
    return np.stack(chosen), cache


def _leaves(cache) -> dict:
    out = {}
    tree_map_with_path(lambda p, x: out.__setitem__("/".join(map(str, p)), x.numpy()), cache)
    return out


def _assert_cache_close(got: dict, ref: dict, name: str, rows=slice(None)):
    for path, g in got.items():
        w = ref[f"{name}/cache/{path}"]
        if path.endswith("index"):
            np.testing.assert_array_equal(g, w, err_msg=path)
        elif g.dtype == np.int8:
            diff = g[:, rows].astype(np.int32) - w[:, rows].astype(np.int32)
            assert np.abs(diff).max() <= 1, path
        elif path.endswith("scale"):
            np.testing.assert_allclose(g[:, rows], w[:, rows], rtol=1e-5, atol=0, err_msg=path)
        else:
            np.testing.assert_allclose(g[:, rows], w[:, rows], rtol=0, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_auto_pipeline_matches_the_reference_pipeline(ref, model, shape, kv_quant):
    ct, pt = model
    name = f"auto{shape}{kv_quant}"
    step = PL.build_pipeline_step(ct, LM.make_host_mesh(shape, device="cpu"))
    cache = TTF.init_cache(ct, B, T, kv_quant=kv_quant, device="cpu")
    chosen, cache = _drive(step, pt, cache, ref[f"{name}/fed"])
    np.testing.assert_array_equal(chosen, ref[f"{name}/chosen"])
    _assert_cache_close(_leaves(cache), ref, name)


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)], ids=["2x2", "pod2x2x2"])
def test_manual_pipeline_matches_the_reference_pipeline(ref, model, shape):
    ct, pt = model
    name = f"manual{shape}"
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = LM.make_host_mesh(shape, axes, device="cpu")
    step = PL.build_pipeline_step(ct, mesh, manual=True)
    cache = PM.init_kv_cache(ct, B, T, tp=mesh.shape["model"], device="cpu")
    chosen, cache = _drive(step, pt, cache, ref[f"{name}/fed"])
    np.testing.assert_array_equal(chosen, ref[f"{name}/chosen"])
    pods = mesh.shape.get("pod", 1)
    _assert_cache_close(_leaves(cache), ref, name, rows=slice(0, B // pods))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_placed_auto_pipeline_matches_the_reference_pipeline(ref, model, shape, kv_quant):
    ct, pt = model
    name = f"auto{shape}{kv_quant}"
    mesh = LM.make_host_mesh(shape, device="cpu")
    step = PL.build_pipeline_step(ct, mesh)
    pp, pc = PL.place(ct, mesh, pt, TTF.init_cache(ct, B, T, kv_quant=kv_quant, device="cpu"))
    chosen, pc = _drive(step, pp, pc, ref[f"{name}/fed"])
    np.testing.assert_array_equal(chosen, ref[f"{name}/chosen"])
    _assert_cache_close(_leaves(SR.global_view(pc)), ref, name)


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)], ids=["2x2", "pod2x2x2"])
def test_placed_manual_pipeline_matches_the_reference_pipeline(ref, model, shape):
    ct, pt = model
    name = f"manual{shape}"
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = LM.make_host_mesh(shape, axes, device="cpu")
    step = PL.build_pipeline_step(ct, mesh, manual=True)
    cache = PM.init_kv_cache(ct, B, T, tp=mesh.shape["model"], device="cpu")
    pp, pc = PL.place(ct, mesh, pt, cache, manual=True)
    chosen, pc = _drive(step, pp, pc, ref[f"{name}/fed"])
    np.testing.assert_array_equal(chosen, ref[f"{name}/chosen"])
    pods = mesh.shape.get("pod", 1)
    _assert_cache_close(_leaves(SR.global_view(pc)), ref, name, rows=slice(0, B // pods))
