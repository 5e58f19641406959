"""The port's dry-run (``repro_torch.launch.dryrun``) against what XLA
reports for the reference's: per-device argument bytes equal to the
compiled step's ``argument_size_in_bytes`` exactly, and the ``meta``
trace's outputs with the reference's shapes and dtypes, for reduced archs x
train, prefill and decode x meshes (2, 2), (16, 16) and (2, 16, 16), and the
manual pipeline decoder (``dryrun_cases.py``). The reference compiles in
one subprocess on 512 fake CPU devices (``dryrun_reference.py``). This
file holds llama (and the pipeline) and dbrx; ``_zoo`` jamba's prefill and
decode, rwkv6 and whisper; ``_jamba`` jamba's train steps, the slowest to
compile. Then ``run_one`` at full size on every arch at decode_32k and
long_500k, on both production meshes."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dryrun_cases as C
from repro_torch.configs import base as cfgbase
from repro_torch.launch import dryrun as DR
from repro_torch.launch import shapes as SH
from repro_torch.launch import sharding as SR
from repro_torch.launch.mesh import make_host_mesh

ROOT = Path(__file__).resolve().parents[1]
PICK = ["llama3.2-1b", "dbrx-132b"]


def reference(tmp_path, argv) -> dict:
    out = tmp_path / "ref.json"
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "dryrun_reference.py"), str(out), *argv],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}", "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"},
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


def port_case(arch, kind, mshape, pipeline):
    """(per-device argument bytes, output (shape, dtype) list) of the port's
    dry-run of one case, traced at full depth."""
    cfg = cfgbase.get(arch).reduced()
    if pipeline:
        cfg = dataclasses.replace(cfg, **C.PIPE_CFG)
    mesh = make_host_mesh(mshape, C.axes_of(mshape), device="meta")
    shape = SH.InputShape(*C.SHAPES[kind])
    nodes, mb = C.train_layout(arch)
    tr = DR.trace(cfg, mesh, shape, full_depth=True, num_nodes=nodes, microbatches=mb,
                  serve_layout="pipeline" if pipeline else "sharded")
    outs = [[list(x.shape), str(x.dtype).removeprefix("torch.")] for _p, x in DR.flat_leaves(tr.outputs)]
    return tr.arg_bytes, outs


def check_case(ref, case):
    cid, arch, kind, mshape, pipeline = case
    got_bytes, got_out = port_case(arch, kind, mshape, pipeline)
    want = ref[cid]
    assert got_bytes == want["arg_bytes"], (cid, got_bytes, want["arg_bytes"])
    assert got_out == want["out"], cid


CASES = [c for c in C.cases() if C.selected(c[0], PICK)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("dryrun"), PICK)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_argument_bytes_and_outputs_match_the_reference(ref, case):
    check_case(ref, case)


@pytest.mark.parametrize("arch", cfgbase.ASSIGNED_ARCHS)
def test_run_one_full_size_decode_rows_are_ok(arch):
    cfg = cfgbase.get(arch)
    for shape_name in ("decode_32k", "long_500k"):
        for mp in (False, True):
            row = DR.run_one(arch, shape_name, multi_pod=mp)
            assert row["status"] == "ok", row
            assert row["traced_layers"] == cfg.period
            assert row["per_device_hbm_gb"] > 0 and row["compile_s"] is None
            for key in ("raw_cost_flops", "hlo_collectives", "collective_ops", "unknown_loops"):
                assert row[key] is None


def test_indivisible_spec_raises():
    # An input whose spec does not divide it fails, as a jit argument does.
    mesh = make_host_mesh((2, 2), device="meta")
    x = torch.empty((3, 4), device="meta")
    with pytest.raises(ValueError, match="does not split"):
        DR.argument_bytes((x,), (SR.P("data"),), mesh)
