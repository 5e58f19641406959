"""Runs the JAX reference's pipeline decoders on fake CPU devices and saves
what they chose, for the port's tests to hold their own pipelines to.

    python tests/pipeline_reference.py OUT.npz llama|zoo|depth

``llama``: the reduced llama in the shape of the reference's manual-pipeline
test, the auto variant on meshes (2, 2) and (4, 1) with the plain and the
int8 cache, the manual variant on (2, 2) and (pod 2, 2, 2). ``zoo``: the
auto variant with the plain cache on (2, 2) for every reduced decoder-only
arch. ``depth``: that llama at llama3.2-1b's full depth (16 layers), the
auto variant on (4, 2) with the int8 cache, batch 8 (two rows a
microgroup), 16 steps. Each case decodes from tokens 1..B, feeding back its own choice, and
saves the tokens fed, the tokens chosen and the final cache leaves. Weights
are ``init_params(PRNGKey(0), cfg)``, as the tests draw them.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as cfgbase  # noqa: E402
from repro.launch.sharding import _path_str  # noqa: E402
from repro.models import transformer as TF  # noqa: E402
from repro.serve import pipeline as PL  # noqa: E402
from repro.serve import pipeline_manual as PM  # noqa: E402

B, T = 4, 16
DEPTH_LAYERS, DEPTH_BATCH, DEPTH_STEPS = 16, 8, 16
SHAPE = dict(num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32, d_model=128,
             d_ff=256, vocab_size=512)
DECODER_ONLY = ["llama32_1b", "stablelm_3b", "mistral_large_123b", "minicpm_2b",
                "internvl2_76b", "dbrx_132b", "arctic_480b", "jamba_v01_52b", "rwkv6_3b"]


def llama_shape():
    return dataclasses.replace(cfgbase.get("llama32_1b").reduced(), **SHAPE)


def mesh_of(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def decode(out, name, cfg, shape, *, manual, kv_quant, steps, b=B):
    mesh = mesh_of(shape)
    params = TF.init_params(jax.random.PRNGKey(0), cfg)
    step = jax.jit(PL.build_pipeline_step(cfg, mesh, manual=manual))
    if manual:
        cache = PM.init_kv_cache(cfg, b, T, tp=mesh.shape["model"])
    else:
        cache = TF.init_cache(cfg, b, T, kv_quant=kv_quant)
    t = jnp.arange(1, b + 1, dtype=jnp.int32)
    fed, chosen = [], []
    for _ in range(steps):
        fed.append(np.asarray(t))
        t, cache = step(params, t, cache)
        chosen.append(np.asarray(t))
    out[f"{name}/fed"] = np.stack(fed)
    out[f"{name}/chosen"] = np.stack(chosen)
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        out[f"{name}/cache/{_path_str(path)}"] = np.asarray(leaf)


def main(path, which):
    out = {}
    if which == "llama":
        cfg = llama_shape()
        for shape in ((2, 2), (4, 1)):
            for q in (False, True):
                decode(out, f"auto{shape}{q}", cfg, shape, manual=False, kv_quant=q, steps=4)
        for shape in ((2, 2), (2, 2, 2)):
            decode(out, f"manual{shape}", cfg, shape, manual=True, kv_quant=True, steps=4)
    elif which == "depth":
        cfg = dataclasses.replace(llama_shape(), num_layers=DEPTH_LAYERS)
        decode(out, "depth", cfg, (4, 2), manual=False, kv_quant=True, steps=DEPTH_STEPS,
               b=DEPTH_BATCH)
    else:
        for arch in DECODER_ONLY:
            decode(out, arch, cfgbase.get(arch).reduced(), (2, 2), manual=False,
                   kv_quant=False, steps=3)
    np.savez(path, **out)
    print("OK")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
