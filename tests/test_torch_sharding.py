"""The port's mesh and sharding rules (``launch/mesh.py``,
``launch/sharding.py``, the pipelines' spec functions) against the JAX
reference, and the two collectives the pipeline decoders add to
``core/mesh.py``.

Every spec is a pure function of paths, shapes and ``mesh.shape``: the port
reads the shape from a stand-in object, the reference from a
``jax.sharding.AbstractMesh`` of the same shape, so no fake devices are
needed. Specs are compared entry for entry, leaf by leaf, by path.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import base as jcfg
from repro.launch import mesh as jmesh
from repro.launch import sharding as JSR
from repro.models import transformer as JTF
from repro.serve import pipeline as JPL
from repro.serve import pipeline_manual as JPM
from repro_torch.configs import base as tcfg
from repro_torch.core import mesh as mesh_mod
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as SR
from repro_torch.models import transformer as TTF
from repro_torch.serve import pipeline as TPL
from repro_torch.serve import pipeline_manual as TPM

ARCHS = list(jcfg.all_arch_ids())
MESHES = {
    "pod16x16": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
    "host2x2": ((2, 2), ("data", "model")),
    "host4x2": ((4, 2), ("data", "model")),
    "pod2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(name):
    shape, axes = MESHES[name]
    port = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    return port, AbstractMesh(shape, axes)


def _spec_items(tree) -> dict:
    """{path: spec tuple} of a port spec tree (specs are tuples, so walk by
    hand instead of through the tree helpers)."""
    out = {}

    def walk(t, path):
        if isinstance(t, SR.PartitionSpec):
            out["/".join(str(p) for p in path)] = tuple(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))

    walk(tree, ())
    return out


def _ref_items(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (NamedSharding, jax.sharding.PartitionSpec)))
    return {JSR._path_str(p): tuple(getattr(s, "spec", s)) for p, s in flat}


def _shapes(arch):
    cj, ct = jcfg.get(arch).reduced(), tcfg.get(arch).reduced()
    return cj, ct, jax.eval_shape(lambda: JTF.init_params(jax.random.PRNGKey(0), cj)), \
        TTF.init_params(0, ct, device="meta")


# -- launch/mesh.py ------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("num_nodes", [1, 2, 4, 6, 16, 32, 256, 512])
def test_node_axes_for_matches_reference(name, num_nodes):
    port, ref = _meshes(name)
    assert tmesh.node_axes_for(num_nodes, port) == jmesh.node_axes_for(num_nodes, ref)


def test_production_and_host_meshes():
    single = tmesh.make_production_mesh(device="cpu")
    multi = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert multi.device_set == {torch.device("cpu")}
    host = tmesh.make_host_mesh((4, 2), device="cpu")
    assert host.shape == {"data": 4, "model": 2} and host.axis_names == ("data", "model")
    assert tmesh.make_host_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu").size == 8


# -- core/mesh.py additions ------------------------------------------------------


def test_psum_adds_in_rank_order_and_replicates():
    rng = np.random.default_rng(0)
    parts = [torch.as_tensor(rng.standard_normal((3, 5)).astype(np.float32)) for _ in range(4)]
    cpu = [torch.device("cpu")] * 4
    out = mesh_mod.psum(parts, cpu)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert len(out) == 4 and all(torch.equal(o, want) for o in out)


def test_all_gather_along_a_feature_axis_is_tiled():
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    slabs = list(x.split(2, dim=1))
    assert torch.equal(mesh_mod.all_gather(slabs, torch.device("cpu"), axis=1), x)
    assert torch.equal(mesh_mod.all_gather(list(x.split(1)), torch.device("cpu")), x)


# -- launch/sharding.py ------------------------------------------------------------


@pytest.mark.parametrize("name", ["pod16x16", "multipod", "host2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch, name):
    cj, ct, sj, st = _shapes(arch)
    port, ref = _meshes(name)
    for nodes in (None, 2, 32):
        got = _spec_items(SR.param_shardings(st, ct, port, num_nodes=nodes))
        want = _ref_items(JSR.param_shardings(sj, cj, ref, num_nodes=nodes))
        assert got == want, (arch, name, nodes)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_spec_matches_reference_on_node_stacked_leaves(arch):
    """leaf_spec alone, on node-stacked shapes with both node-axis choices."""
    cj, ct, sj, _ = _shapes(arch)
    port, ref = _meshes("multipod")
    flat, _ = jax.tree_util.tree_flatten_with_path(sj)
    for path, leaf in flat:
        pstr = JSR._path_str(path)
        for naxes in ((), ("pod",), ("pod", "data")):
            shape = (4,) + tuple(leaf.shape)
            got = SR.leaf_spec(pstr, shape, ct, port, node_axes=naxes, has_node_axis=True)
            want = JSR.leaf_spec(pstr, shape, cj, ref, node_axes=naxes, has_node_axis=True)
            assert tuple(got) == tuple(want), (pstr, naxes)


@pytest.mark.parametrize("name", ["pod16x16", "multipod", "host2x2"])
@pytest.mark.parametrize("layout", ["tp", "fsdp_model"])
def test_batch_shardings_match_reference(name, layout):
    port, ref = _meshes(name)
    for nodes in (1, 2, 16, 32):
        shapes = {"tokens": (2, nodes, 64, 128), "labels": (2, nodes, 6, 128),
                  "frames": (1, nodes, 32, 10, 8)}
        got = _spec_items(SR.batch_shardings(
            {k: torch.empty(s, device="meta") for k, s in shapes.items()}, port,
            num_nodes=nodes, layout=layout))
        want = _ref_items(JSR.batch_shardings(
            {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in shapes.items()}, ref,
            num_nodes=nodes, layout=layout))
        assert got == want, (nodes, layout)


@pytest.mark.parametrize("name", ["pod16x16", "host2x2", "host4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_prefill_shardings_match_reference(arch, name):
    cj, ct = jcfg.get(arch).reduced(), tcfg.get(arch).reduced()
    port, ref = _meshes(name)
    for b, t in ((16, 32), (6, 16)):
        jc = jax.eval_shape(lambda: JTF.init_cache(cj, b, t))
        tc = TTF.init_cache(ct, b, t, device="meta")
        tok = (b,)
        mem = (b, 10, ct.d_model)
        got = _spec_items(SR.decode_shardings(
            {"cache": tc, "token": torch.empty(tok, device="meta"),
             "memory": torch.empty(mem, device="meta")}, ct, port))
        want = _ref_items(JSR.decode_shardings(
            {"cache": jc, "token": jax.ShapeDtypeStruct(tok, np.int32),
             "memory": jax.ShapeDtypeStruct(mem, np.float32)}, cj, ref))
        assert got == want, (arch, b, t)
        pin = {"tokens": (b, t), "frames": (b, 10, ct.d_model)}
        got = _spec_items(SR.prefill_shardings(
            {k: torch.empty(s, device="meta") for k, s in pin.items()}, port))
        want = _ref_items(JSR.prefill_shardings(
            {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in pin.items()}, ref))
        assert got == want


def test_local_slab_cuts_a_view_by_spec():
    port = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 4})
    x = torch.arange(2 * 8 * 12, dtype=torch.float32).reshape(2, 8, 12)
    spec = SR.P(None, ("pod", "data"), "model")
    pos = {"pod": 1, "data": 0, "model": 3}
    got = SR.local_slab(x, spec, port, pos)
    assert torch.equal(got, x[:, 4:6, 9:12])
    assert got.data_ptr() == x[:, 4:6, 9:12].data_ptr()  # a view
    with pytest.raises(ValueError, match="does not split"):
        SR.local_slab(torch.zeros(3, 4), SR.P("model"), port, pos)


# -- the pipelines' specs ------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_stage_shardings_match_reference(arch, kv_quant):
    cj, ct = jcfg.get(arch).reduced(), tcfg.get(arch).reduced()
    port, ref = _meshes("host2x2")
    _, jp, jc = JPL.stage_shardings(cj, ref, batch=4, kv_quant=kv_quant)
    _, tp, tc = TPL.stage_shardings(ct, port, batch=4, kv_quant=kv_quant)
    assert _spec_items(tp) == _ref_items(jp)
    assert _spec_items(tc) == _ref_items(jc)


@pytest.mark.parametrize("name", ["host2x2", "pod16x16", "multipod"])
def test_manual_param_and_cache_shardings_match_reference(name):
    cj, ct, sj, st = _shapes("llama32_1b")
    port, ref = _meshes(name)
    assert _spec_items(TPM.param_shardings(ct, port, st)) == \
        _ref_items(JPM.param_shardings(cj, ref, sj))
    assert _spec_items(TPM.cache_shardings(port)) == _ref_items(JPM.cache_shardings(ref))


def test_manual_cache_layout_is_the_reference_one_head_a_rank():
    """One KV head a rank (tp = hkv): the reference's (G, B, T, tp, hd)."""
    cj, ct = jcfg.get("llama32_1b").reduced(), tcfg.get("llama32_1b").reduced()
    for tp in (4, 8):
        want = jax.eval_shape(lambda tp=tp: JPM.init_kv_cache(cj, 2, 8, tp))
        got = TPM.init_kv_cache(ct, 2, 8, tp, device="cpu")
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape) and str(got[k].dtype) == f"torch.{w.dtype}"
    # a rank whose query heads span two KV heads keeps both (the port's repair)
    assert TPM.init_kv_cache(ct, 2, 8, 2, device="cpu")["k"].shape[3] == 4
