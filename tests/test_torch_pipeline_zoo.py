"""The port's auto pipeline decoder against the JAX reference's, for every
reduced decoder-only arch of the zoo (dense, MoE, the Mamba hybrid, RWKV-6),
on mesh (2, 2) with the plain cache: the reference runs in a subprocess on
8 fake CPU devices (``tests/pipeline_reference.py``) and the port, fed the
same tokens on the reference's weights, chooses the same tokens. (For the
MoE archs the pipeline's tokens may differ from ``decode_step``'s in both
packages: a microgroup is routed as a capacity group of its own.) The
encoder-decoder arch is refused by both with the same ``ValueError``.
"""

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
from repro.serve import pipeline as JPL
from repro_torch.configs import base as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.launch import mesh as LM
from repro_torch.models import transformer as TTF
from repro_torch.serve import pipeline as PL

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama32_1b", "stablelm_3b", "mistral_large_123b", "minicpm_2b", "internvl2_76b",
         "dbrx_132b", "arctic_480b", "jamba_v01_52b", "rwkv6_3b"]
B, T = 4, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "zoo.npz"
    r = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "pipeline_reference.py"), str(out), "zoo"],
        capture_output=True, text=True, timeout=400,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
    )
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]
    return dict(np.load(out))


def test_every_decoder_only_arch_is_covered():
    decoder_only = sorted(a for a in jcfg.all_arch_ids() if not jcfg.get(a).enc_dec)
    assert sorted(ARCHS) == decoder_only


@requires_axis_type
@pytest.mark.parametrize("arch", ARCHS)
def test_auto_pipeline_tokens_match_the_reference_pipeline(ref, arch):
    cj, ct = jcfg.get(arch).reduced(), tcfg.get(arch).reduced()
    pt = params_from_numpy(
        jax.tree.map(np.asarray, JTF.init_params(jax.random.PRNGKey(0), cj)), "cpu")
    step = PL.build_pipeline_step(ct, LM.make_host_mesh((2, 2), device="cpu"))
    cache = TTF.init_cache(ct, B, T, device="cpu")
    for t, want in zip(ref[f"{arch}/fed"], ref[f"{arch}/chosen"]):
        tok, cache = step(pt, torch.as_tensor(np.array(t)), cache)
        np.testing.assert_array_equal(tok.numpy(), want, err_msg=arch)


@pytest.mark.parametrize("manual", [False, True])
def test_encoder_decoder_is_refused_by_both(manual):
    cj, ct = jcfg.get("whisper_base").reduced(), tcfg.get("whisper_base").reduced()
    with pytest.raises(ValueError) as want:
        JPL.build_pipeline_step(cj, jax.make_mesh((1, 1), ("data", "model")), manual=manual)
    with pytest.raises(ValueError) as got:
        PL.build_pipeline_step(ct, LM.make_host_mesh((1, 1), device="cpu"), manual=manual)
    assert str(got.value) == str(want.value)
