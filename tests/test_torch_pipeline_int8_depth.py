"""The port's auto pipeline with the int8 cache at full depth, held to the
JAX reference's own pipeline (``tests/pipeline_reference.py depth``, on 8
fake CPU devices in a subprocess), and to the port's own serve step run
over each microgroup's rows alone.

The reduced llama's widths at llama3.2-1b's 16 layers, mesh (data 4, model
2), batch 8 (two rows a microgroup), 16 decode steps. Fed the tokens the
reference's pipeline was fed:

- the port chooses the same tokens, and every group of its int8 cache is
  within one quantization level of the reference's: the whole cache, not
  its first group;
- the scales are within 1e-5 relative up to the first group where a level
  differs. There the value before rounding lies a rounding step from a
  half level (123.4999847 against the reference's 124 on this input), and
  the dequantized keys then differ by a whole level, which every later
  group reads: its scales are held within 1e-3 relative (1.0e-4 at most on
  this input; the plain cache stays within 1.1e-6 at every depth);
- against the microgroup control (``build_serve_step`` over rows
  [2m, 2m + 2) alone, the caches concatenated) the whole cache is within
  one level and its scales within 1e-5: the pipeline's rows see the same
  matmul shapes as the control's.
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
from repro_torch.launch import steps as ST
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF
from repro_torch.serve import pipeline as PL

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(num_layers=16, num_heads=4, num_kv_heads=2, head_dim=32, d_model=128,
             d_ff=256, vocab_size=512)
B, T, STEPS, STAGES = 8, 16, 16, 4
# A level flip is rounding: before it, the value lay this near a half level.
NEAR_HALF = 1e-3
SCALE_RTOL, SCALE_RTOL_PAST_FLIP = 1e-5, 1e-3

pytestmark = requires_axis_type


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixer(cache) -> dict:
    return {k: x.numpy() for k, x in cache["layer0"]["mixer"].items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's saved arrays, and the port's: the pipeline's chosen
    tokens, cache, and each quantized (scale, head) -> the values it
    rounded; the microgroup control's cache."""
    out = tmp_path_factory.mktemp("ref") / "depth.npz"
    r = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "pipeline_reference.py"), str(out), "depth"],
        capture_output=True, text=True, timeout=400,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
    )
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]
    ref = dict(np.load(out))
    cj = dataclasses.replace(jcfg.get("llama32_1b").reduced(), **SHAPE)
    ct = dataclasses.replace(tcfg.get("llama32_1b").reduced(), **SHAPE)
    params = params_from_numpy(
        jax.tree.map(np.asarray, JTF.init_params(jax.random.PRNGKey(0), cj)), "cpu")
    fed = [torch.as_tensor(np.array(t)) for t in ref["depth/fed"]]

    rounded = {}
    quant = TL._quant_kv

    def spy(x):
        q, scale = quant(x)
        vals, sc = (x.float() / scale).numpy(), scale.numpy()
        for b, t, h in np.ndindex(*sc.shape[:3]):
            rounded[(float(sc[b, t, h, 0]), h)] = vals[b, t, h]
        return q, scale

    mp = pytest.MonkeyPatch()
    mp.setattr(TL, "_quant_kv", spy)
    try:
        step = PL.build_pipeline_step(ct, LM.make_host_mesh((STAGES, 2), device="cpu"))
        cache = TTF.init_cache(ct, B, T, kv_quant=True, device="cpu")
        chosen = []
        for t in fed:
            tok, cache = step(params, t, cache)
            chosen.append(tok.numpy())
    finally:
        mp.undo()

    serve, mb, parts = ST.build_serve_step(ct), B // STAGES, []
    for m in range(STAGES):
        c = TTF.init_cache(ct, mb, T, kv_quant=True, device="cpu")
        for t in fed:
            _, c = serve(params, t[m * mb:(m + 1) * mb], c)
        parts.append(_mixer(c))
    control = {k: parts[0][k] if k == "index" else np.concatenate([p[k] for p in parts], 1)
               for k in parts[0]}
    return ref, np.stack(chosen), _mixer(cache), rounded, control


def _want(ref) -> dict:
    return {k: ref[f"depth/cache/layer0/mixer/{k}"] for k in ("k", "v", "k_scale", "v_scale",
                                                               "index")}


def _levels_by_group(got, want) -> list[int]:
    return [int(max(np.abs(got[k][g].astype(np.int32) - want[k][g].astype(np.int32)).max()
                    for k in ("k", "v"))) for g in range(got["k"].shape[0])]


def _scale_rel_by_group(got, want) -> np.ndarray:
    return np.array([max(float((np.abs(got[k][g] - want[k][g]) / np.abs(want[k][g])).max())
                         for k in ("k_scale", "v_scale")) for g in range(got["k"].shape[0])])


def test_the_reference_ran_full_depth(run):
    ref, _, got, _, _ = run
    assert ref["depth/fed"].shape == (STEPS, B)
    assert got["k"].dtype == np.int8 and got["k"].shape[:2] == (SHAPE["num_layers"], B)


def test_tokens_are_the_references(run):
    ref, chosen, _, _, _ = run
    np.testing.assert_array_equal(chosen, ref["depth/chosen"])


def test_whole_int8_cache_within_one_level_of_the_reference(run):
    ref, _, got, _, _ = run
    want = _want(ref)
    np.testing.assert_array_equal(got["index"], want["index"])
    levels = _levels_by_group(got, want)
    assert max(levels) <= 1, f"levels by group {levels}"


def test_scales_hold_to_the_first_level_flip_and_the_flip_is_rounding(run):
    ref, _, got, rounded, _ = run
    want = _want(ref)
    levels = _levels_by_group(got, want)
    first = next((g for g, lv in enumerate(levels) if lv), len(levels))
    rel = _scale_rel_by_group(got, want)
    assert rel[:first + 1].max() <= SCALE_RTOL, rel.tolist()
    assert rel.max() <= SCALE_RTOL_PAST_FLIP, rel.tolist()
    if first == len(levels):
        return
    for k in ("k", "v"):
        for b, t, h, d in zip(*np.nonzero(got[k][first] != want[k][first])):
            before = rounded[(float(got[f"{k}_scale"][first, b, t, h, 0]), h)][d]
            assert abs(abs(before) % 1.0 - 0.5) <= NEAR_HALF, (k, b, t, h, d, before)


def test_whole_int8_cache_within_one_level_of_the_microgroup_control(run):
    _, _, got, _, control = run
    np.testing.assert_array_equal(got["index"], control["index"])
    levels = _levels_by_group(got, control)
    assert max(levels) <= 1, f"levels by group {levels}"
    assert _scale_rel_by_group(got, control).max() <= SCALE_RTOL
