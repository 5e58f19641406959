"""Compiles the JAX reference's dry-run steps on 512 fake CPU devices and
saves what XLA reports, for the port's dry-run tests to hold their own
counts to.

    python tests/dryrun_reference.py OUT.json [ARCH[:KIND] ...]

For every case of ``dryrun_cases.cases()`` that the selectors pick (all
without any) it builds the step with the
reference's ``launch/dryrun`` builders, compiles it with their shardings,
and writes the per-device ``argument_size_in_bytes`` and the shape and
dtype of every output leaf (``jax.tree`` order).
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import dataclasses  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402

import dryrun_cases as C  # noqa: E402
from repro.configs import base as cfgbase  # noqa: E402
from repro.launch import dryrun as DR  # noqa: E402
from repro.launch import shapes as SH  # noqa: E402


def one(arch, kind, mshape, pipeline):
    cfg = cfgbase.get(arch).reduced()
    if pipeline:
        cfg = dataclasses.replace(cfg, **C.PIPE_CFG)
    axes = C.axes_of(mshape)
    mesh = jax.make_mesh(mshape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    shape = SH.InputShape(*C.SHAPES[kind])
    if kind == "train":
        nodes, mb = C.train_layout(arch)
        built = DR.build_train(cfg, mesh, shape, num_nodes=nodes, microbatches=mb)
    elif kind == "prefill":
        built = DR.build_prefill(cfg, mesh, shape)
    elif pipeline:
        built = DR.build_decode_pipeline(cfg, mesh, shape)
    else:
        built = DR.build_decode(cfg, mesh, shape)
    fn, args, in_sh, out_sh, donate = built
    jitted = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh, donate_argnums=donate)
    compiled = jitted.lower(*args).compile()
    outs = jax.eval_shape(fn, *args)
    return {
        "arg_bytes": int(compiled.memory_analysis().argument_size_in_bytes),
        "out": [[list(x.shape), str(x.dtype)] for x in jax.tree.leaves(outs)],
    }


def main(path, picks):
    res = {}
    for cid, arch, kind, mshape, pipeline in C.cases():
        if picks and not C.selected(cid, picks):
            continue
        t0 = time.perf_counter()
        res[cid] = one(arch, kind, mshape, pipeline)
        print(f"{cid}: {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    with open(path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
