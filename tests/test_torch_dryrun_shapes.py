"""The port's dry-run input specs (``repro_torch.launch.shapes`` and the
frontend specs) against the reference's: every leaf's shape and dtype equal
to the ``ShapeDtypeStruct`` (and ``jax.eval_shape`` cache) the reference
gives, for all 10 archs x 4 shapes, and the reference's own
``tests/test_launch.py::TestShapes`` cases on the port."""

import ast
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import base as ref_cfgbase
from repro.launch import shapes as ref_SH
from repro.models import frontends as ref_FE
from repro_torch.configs import base as cfgbase
from repro_torch.launch import dryrun as DR
from repro_torch.launch import shapes as SH
from repro_torch.models import frontends as FE

ARCHS = cfgbase.ASSIGNED_ARCHS
# The reference's dry-run module sets XLA_FLAGS (512 fake devices) when it is
# imported, which would change every later jax test in this process: its
# MICROBATCHES table is read from the source instead.
REF_DRYRUN = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" / "dryrun.py"


def ref_microbatches() -> dict:
    for node in ast.parse(REF_DRYRUN.read_text()).body:
        if isinstance(node, ast.Assign) and ast.unparse(node.targets[0]) == "MICROBATCHES":
            return ast.literal_eval(node.value)
    raise AssertionError("no MICROBATCHES in the reference's dryrun.py")


def ref_leaves(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)
        out.append((keys, tuple(leaf.shape), str(leaf.dtype)))
    return out


def port_leaves(tree):
    out = []
    for path, leaf in DR.flat_leaves(tree):
        assert leaf.device.type == "meta", path
        out.append((path, tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")))
    return out


def test_registry_and_constants_match():
    assert list(SH.SHAPES) == list(ref_SH.SHAPES)
    for name, s in SH.SHAPES.items():
        r = ref_SH.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (r.name, r.seq_len, r.global_batch, r.kind)
    assert (SH.WHISPER_DEC_LEN, SH.WHISPER_ENC_FRAMES) == (ref_SH.WHISPER_DEC_LEN, ref_SH.WHISPER_ENC_FRAMES)
    assert DR.MICROBATCHES == ref_microbatches()


@pytest.mark.parametrize("shape_name", list(SH.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_match_the_reference(arch, shape_name):
    cfg, ref_cfg = cfgbase.get(arch), ref_cfgbase.get(arch)
    shape, ref_shape = SH.SHAPES[shape_name], ref_SH.SHAPES[shape_name]
    if shape.kind == "train":
        for nodes in (cfg.num_nodes_single_pod, cfg.num_nodes_multi_pod):
            for mb in (1, DR.MICROBATCHES.get(cfg.arch_id, 1)):
                got = SH.train_inputs(cfg, shape, nodes, microbatches=mb)
                want = ref_SH.train_inputs(ref_cfg, ref_shape, nodes, microbatches=mb)
                assert port_leaves(got) == ref_leaves(want), (nodes, mb)
    elif shape.kind == "prefill":
        assert port_leaves(SH.prefill_inputs(cfg, shape)) == ref_leaves(
            ref_SH.prefill_inputs(ref_cfg, ref_shape))
    else:
        assert SH.decode_cache_len(cfg, shape) == ref_SH.decode_cache_len(ref_cfg, ref_shape)
        assert port_leaves(SH.decode_inputs(cfg, shape)) == ref_leaves(
            ref_SH.decode_inputs(ref_cfg, ref_shape))
    assert SH.long_context_applicable(cfg) == ref_SH.long_context_applicable(ref_cfg)


@pytest.mark.parametrize("arch", ["whisper_base", "internvl2_76b", "llama32_1b"])
def test_frontend_specs_match_the_reference(arch):
    cfg, ref_cfg = cfgbase.get(arch), ref_cfgbase.get(arch)
    for got, want in ((FE.audio_frames_spec(cfg, 3, 1500), ref_FE.audio_frames_spec(ref_cfg, 3, 1500)),
                      (FE.patch_embeddings_spec(cfg, 2, 7), ref_FE.patch_embeddings_spec(ref_cfg, 2, 7))):
        assert port_leaves(got) == ref_leaves(want)


@pytest.mark.parametrize("nodes,mb", [(3, 1), (16, 3), (7, 2)])
def test_indivisible_global_batch_raises_as_the_reference(nodes, mb):
    cfg, ref_cfg = cfgbase.get("llama32_1b"), ref_cfgbase.get("llama32_1b")
    with pytest.raises(ValueError, match="not divisible") as got:
        SH.train_inputs(cfg, SH.SHAPES["train_4k"], nodes, microbatches=mb)
    with pytest.raises(ValueError, match="not divisible") as want:
        ref_SH.train_inputs(ref_cfg, ref_SH.SHAPES["train_4k"], nodes, microbatches=mb)
    assert str(got.value) == str(want.value)


def test_wrong_kind_is_refused():
    cfg = cfgbase.get("llama32_1b")
    with pytest.raises(AssertionError):
        SH.prefill_inputs(cfg, SH.SHAPES["decode_32k"])
    with pytest.raises(AssertionError):
        SH.decode_inputs(cfg, SH.SHAPES["train_4k"])


# The reference's tests/test_launch.py::TestShapes, on the port.


def test_four_shapes_registered():
    assert set(SH.SHAPES) == {"train_4k", "prefill_32k", "decode_32k", "long_500k"}
    assert SH.SHAPES["long_500k"].seq_len == 524288
    assert SH.SHAPES["train_4k"].global_batch == 256


@pytest.mark.parametrize("arch", ARCHS)
def test_train_inputs_divide(arch):
    cfg = cfgbase.get(arch)
    shape = SH.SHAPES["train_4k"]
    n = cfg.num_nodes_single_pod
    tok = SH.train_inputs(cfg, shape, n, microbatches=1)["tokens"]
    assert tok.shape[0] == 1 and tok.shape[1] == n
    assert tok.shape[2] * n == shape.global_batch


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_inputs_build(arch):
    cfg = cfgbase.get(arch)
    for name in ("decode_32k", "long_500k"):
        specs = SH.decode_inputs(cfg, SH.SHAPES[name])
        assert specs["token"].shape == (SH.SHAPES[name].global_batch,)
        assert specs["token"].dtype == torch.int32
        # long_500k must be sub-quadratic: attention caches bounded by window
        if name == "long_500k":
            for path, leaf in DR.flat_leaves(specs["cache"]):
                if path[-1] == "k":
                    assert leaf.shape[2] <= cfg.sliding_window


def test_long_context_applicable_everywhere():
    for arch in ARCHS:
        ok, why = SH.long_context_applicable(cfgbase.get(arch))
        assert ok, (arch, why)
