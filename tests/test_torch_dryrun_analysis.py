"""The port's analytic roofline (``repro_torch.launch.analysis``) against the
reference's: every term and every ``Roofline.row()`` field within rel 1e-12,
for all 10 archs x 4 shapes x both production meshes x every layout, gossip
and serve layout the step takes, with the reference's hardware constants
passed in. Then the reference's ``tests/test_launch.py::TestAnalyticTerms``
cases on the port."""

import math
import types

import pytest

from repro.configs import base as ref_cfgbase
from repro.launch import analysis as ref_AN
from repro.launch import mesh as ref_M
from repro_torch.configs import base as cfgbase
from repro_torch.launch import analysis as AN
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.launch import shapes as SH

REL = 1e-12
REF_HW = M.Hardware(ref_M.PEAK_FLOPS_BF16, ref_M.HBM_BW, ref_M.ICI_BW)
XLA_ONLY = ("hlo_collectives", "collective_ops", "raw_cost_flops", "unknown_loops")


def close(a, b):
    return a == b or math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, str):
        assert got == want, what
    else:
        assert close(got, want), (what, got, want)


def options(kind):
    """(layout, gossip, serve_layout) the step of ``kind`` reads."""
    if kind == "train":
        return [(lay, gos, "sharded") for lay in ("tp", "fsdp_model") for gos in ("dense", "sparse")]
    if kind == "decode":
        return [("tp", "dense", sl) for sl in ("sharded", "pipeline")]
    return [("tp", "dense", "sharded")]


def row_inputs(cfg, shape, multi_pod):
    """The keywords ``run_one`` gives ``analyze`` (bar the bytes)."""
    eff_seq = SH.WHISPER_DEC_LEN if cfg.enc_dec else shape.seq_len
    num_nodes = cfg.num_nodes_multi_pod if multi_pod else cfg.num_nodes_single_pod
    mb, window, cache_len = 1, None, 0
    if shape.kind == "train":
        mb = DR.MICROBATCHES.get(cfg.arch_id, 1)
        model_flops = 6.0 * AN.active_param_count(cfg) * shape.global_batch * eff_seq
    elif shape.kind == "prefill":
        model_flops = 2.0 * AN.active_param_count(cfg) * shape.global_batch * eff_seq
    else:
        window = cfg.sliding_window if shape.name == "long_500k" else None
        cache_len = SH.decode_cache_len(cfg, shape)
        model_flops = 2.0 * AN.active_param_count(cfg) * shape.global_batch
    return dict(
        arch=cfg.arch_id, shape=shape.name, mesh_name="2x16x16" if multi_pod else "16x16",
        chips=512 if multi_pod else 256, kind=shape.kind, batch=shape.global_batch, seq=eff_seq,
        cache_len=cache_len, window=window, num_nodes=num_nodes, microbatches=mb,
        model_flops=model_flops,
    )


@pytest.mark.parametrize("shape_name", list(SH.SHAPES))
@pytest.mark.parametrize("arch", cfgbase.ASSIGNED_ARCHS)
def test_terms_and_rows_match_the_reference(arch, shape_name):
    cfg, ref_cfg = cfgbase.get(arch), ref_cfgbase.get(arch)
    shape = SH.SHAPES[shape_name]
    same(AN.active_param_count(cfg), ref_AN.active_param_count(ref_cfg), "active")
    same(AN.total_param_count(cfg), ref_AN.total_param_count(ref_cfg), "total")
    same(AN._attn_layer_count(cfg), ref_AN._attn_layer_count(ref_cfg), "attn layers")
    for tokens in (1, 4096, shape.global_batch * shape.seq_len):
        same(AN.model_flops_per_step(cfg, tokens), ref_AN.model_flops_per_step(ref_cfg, tokens),
             "model flops")
    for multi_pod in (False, True):
        kw = row_inputs(cfg, shape, multi_pod)
        flops_kw = dict(kind=kw["kind"], batch=kw["batch"], seq=kw["seq"],
                        cache_len=kw["cache_len"], window=kw["window"])
        same(AN.analytic_step_flops(cfg, **flops_kw),
             ref_AN.analytic_step_flops(ref_cfg, **flops_kw), "step flops")
        # arguments and temporaries of a few sizes, unrelated on purpose
        for arg_b, temp_b in ((123456789.0, 0.0), (5.5e9, 7.25e8)):
            hbm_kw = dict(kind=kw["kind"], num_nodes=kw["num_nodes"],
                          microbatches=kw["microbatches"], arg_bytes=arg_b, temp_bytes=temp_b)
            same(AN.analytic_hbm_bytes_per_device(cfg, **hbm_kw),
                 ref_AN.analytic_hbm_bytes_per_device(ref_cfg, **hbm_kw), "hbm")
            for layout, gossip, serve_layout in options(shape.kind):
                mesh_shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                              else {"data": 16, "model": 16})
                for node_sharded in (False, True):
                    wire_kw = dict(kind=kw["kind"], batch=kw["batch"], seq=kw["seq"],
                                   num_nodes=kw["num_nodes"], microbatches=kw["microbatches"],
                                   mesh_shape=mesh_shape, node_sharded=node_sharded,
                                   layout=layout, gossip=gossip, serve_layout=serve_layout)
                    same(AN.analytic_collective_bytes(cfg, **wire_kw),
                         ref_AN.analytic_collective_bytes(ref_cfg, **wire_kw), "wire")
                got = AN.analyze(cfg=cfg, **kw, arg_bytes=arg_b, temp_bytes=temp_b, layout=layout,
                                 gossip=gossip, serve_layout=serve_layout, hw=REF_HW)
                mem = types.SimpleNamespace(argument_size_in_bytes=arg_b, temp_size_in_bytes=temp_b)
                want = ref_AN.analyze(cfg=ref_cfg, **kw, cost={}, hlo_text="", memory_analysis=mem,
                                      layout=layout, gossip=gossip, serve_layout=serve_layout)
                g_row, w_row = got.row(), want.row()
                assert set(g_row) == set(w_row)
                for key in w_row:
                    if key in XLA_ONLY:
                        assert g_row[key] is None, key
                    else:
                        same(g_row[key], w_row[key], f"{arch} {shape_name} {layout} {gossip} "
                                                     f"{serve_layout} {key}")
                for field in ("compute_s", "memory_s", "collective_s", "hbm_bytes_dev",
                              "wire_bytes", "per_device_hbm"):
                    same(getattr(got, field), getattr(want, field), field)


def test_h100_is_the_default_and_the_link_is_the_slowest():
    cfg = cfgbase.get("llama32_1b")
    kw = row_inputs(cfg, SH.SHAPES["decode_32k"], False)
    got = AN.analyze(cfg=cfg, **kw, arg_bytes=1e9)
    assert got.memory_s == pytest.approx(1e9 / 3.35e12, rel=REL)
    assert got.compute_s == pytest.approx(got.step_flops / (256 * 989.4e12), rel=REL)
    assert got.collective_s == pytest.approx(got.wire_bytes / 50e9, rel=REL)
    assert M.H100.link_bw < M.H100.hbm_bw < M.H100.peak_flops_bf16
    assert got.row()["per_device_hbm_gb"] == 1.0


# The reference's tests/test_launch.py::TestAnalyticTerms, on the port.


def test_step_flops_scales_with_tokens():
    cfg = cfgbase.get("llama32_1b")
    f1 = AN.analytic_step_flops(cfg, kind="prefill", batch=1, seq=1024)
    f2 = AN.analytic_step_flops(cfg, kind="prefill", batch=2, seq=1024)
    assert f2 / f1 == pytest.approx(2.0, rel=0.05)


def test_train_is_3x_prefill():
    cfg = cfgbase.get("stablelm_3b")
    fp = AN.analytic_step_flops(cfg, kind="prefill", batch=4, seq=512)
    ft = AN.analytic_step_flops(cfg, kind="train", batch=4, seq=512)
    assert ft / fp == pytest.approx(3.0, rel=0.01)


def test_moe_active_vs_total():
    cfg = cfgbase.get("arctic_480b")
    # 128 experts top-2 -> active far below total
    assert AN.active_param_count(cfg) < 0.1 * AN.total_param_count(cfg)


def test_window_caps_attention_flops():
    cfg = cfgbase.get("llama32_1b")
    full = AN.analytic_step_flops(cfg, kind="decode", batch=1, seq=0, cache_len=524288)
    win = AN.analytic_step_flops(cfg, kind="decode", batch=1, seq=0, cache_len=524288, window=4096)
    assert win < full


def test_collective_model_modes():
    cfg = cfgbase.get("llama32_1b")
    mesh = {"data": 16, "model": 16}
    base = AN.analytic_collective_bytes(
        cfg, kind="train", batch=256, seq=4096, num_nodes=16,
        microbatches=2, mesh_shape=mesh, node_sharded=True, layout="tp",
    )
    opt = AN.analytic_collective_bytes(
        cfg, kind="train", batch=256, seq=4096, num_nodes=16,
        microbatches=1, mesh_shape=mesh, node_sharded=True, layout="fsdp_model",
    )
    assert sum(opt.values()) < 0.5 * sum(base.values())
    pipe = AN.analytic_collective_bytes(
        cfg, kind="decode", batch=128, seq=32768, num_nodes=1,
        microbatches=1, mesh_shape=mesh, node_sharded=False, serve_layout="pipeline",
    )
    shard = AN.analytic_collective_bytes(
        cfg, kind="decode", batch=128, seq=32768, num_nodes=1,
        microbatches=1, mesh_shape=mesh, node_sharded=False,
    )
    assert pipe.get("serve_ag", 0.0) == 0.0
    assert sum(pipe.values()) < 0.1 * sum(shard.values())
