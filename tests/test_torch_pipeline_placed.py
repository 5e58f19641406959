"""The pipeline decoders on placed trees: ``launch.sharding.place`` and
``global_view``, meshes laid over several devices, and the bytes the step
moves between shards (``core.mesh.wire_bytes``).

The reduced llama in the shape of the reference's manual-pipeline test (4
layers, 4/2 heads, d 128) in f32 on the CPU. Every mesh position here is the
CPU (or, where the copy path is under test, ``meta``), so the tally reads
what the step would move between cards: it counts by shard, whatever the
devices are. No jax.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import base as tcfg
from repro_torch.core import mesh as M
from repro_torch.launch import mesh as LM
from repro_torch.launch import sharding as SR
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as TF
from repro_torch.serve import pipeline as PL
from repro_torch.serve import pipeline_manual as PM
from repro_torch.tree import tree_leaves

SHAPE = dict(num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32, d_model=128,
             d_ff=256, vocab_size=512)
B, T = 4, 16
CPU = torch.device("cpu")
MESHES = {"2x2": ((2, 2), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")), "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
VARIANTS = ["auto_plain", "auto_int8", "manual"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return dataclasses.replace(tcfg.get("llama32_1b").reduced(), **{**SHAPE, **kw})


def _mesh(name, **kw):
    shape, axes = MESHES[name]
    return LM.make_host_mesh(shape, axes, **({"device": "cpu"} | kw))


def _cache(cfg, variant, mesh, t_len=T, device="cpu"):
    if variant == "manual":
        return PM.init_kv_cache(cfg, B, t_len, tp=mesh.shape["model"], device=device)
    return TF.init_cache(cfg, B, t_len, kv_quant=variant == "auto_int8", device=device)


def _fill(tree, seed):
    """Every leaf filled with values from ``seed`` (ints for int leaves)."""
    gen = torch.Generator().manual_seed(seed)
    for x in _leaves(tree):
        if x.dtype.is_floating_point:
            x.copy_(torch.rand(x.shape, generator=gen))
        else:
            x.copy_(torch.randint(-100, 100, x.shape, generator=gen))
    return tree


def _leaves(tree):
    return [x for x in tree_leaves(tree) if x is not None]


def _drive(step, params, cache, steps=2):
    tok = torch.arange(1, B + 1, dtype=torch.int32)
    out = []
    for _ in range(steps):
        tok, cache = step(params, tok, cache)
        out.append(tok)
    return torch.stack(out), cache


# -- launch.mesh: laying a mesh over devices -------------------------------------------


def test_host_mesh_laid_over_cards_row_major():
    cards = [f"cuda:{i}" for i in range(4)]
    m = LM.make_host_mesh((4, 2), devices=cards)
    assert [[d.index for d in row] for row in m.devices] == [[0, 0], [1, 1], [2, 2], [3, 3]]
    m = LM.make_host_mesh((2, 8), devices=cards)
    assert [[d.index for d in row] for row in m.devices] == [[0] * 4 + [1] * 4, [2] * 4 + [3] * 4]
    m = LM.make_host_mesh((2, 2, 2), ("pod", "data", "model"), devices=cards)
    assert [d.index for d in m.devices.ravel()] == [0, 0, 1, 1, 2, 2, 3, 3]
    m = LM.make_host_mesh((1, 2), devices=cards)  # fewer positions than cards
    assert [d.index for d in m.devices.ravel()] == [0, 1]
    m = LM.make_host_mesh((2, 2), devices=cards)
    assert [d.index for d in m.devices.ravel()] == [0, 1, 2, 3]
    p = LM.make_production_mesh(devices=[f"cuda:{i}" for i in range(8)])
    assert p.shape == {"data": 16, "model": 16}
    assert [d.index for d in p.devices.ravel()] == [k // 32 for k in range(256)]
    assert LM.make_host_mesh((2, 2), device="cpu").device_set == {CPU}
    with pytest.raises(ValueError, match="not both"):
        LM.make_host_mesh((2, 2), device="cpu", devices=["cpu"])


# -- core.mesh: the tally --------------------------------------------------------------


def test_collectives_tally_bytes_between_shards_only():
    x = [torch.ones(2, 3) * i for i in range(4)]  # 24 bytes each
    M.reset_wire_bytes()
    M.all_gather(x, CPU, shard=1)
    M.psum(x, [CPU] * 4)
    M.psum_scatter([torch.ones(4, 3)] * 4, [CPU] * 4)
    M.ppermute(x, [(0, 1), (1, 2), (3, 3)], [CPU] * 4)
    assert M.wire_bytes() == {"all-gather": 3 * 24, "all-reduce": 2 * 3 * 24,
                              "reduce-scatter": 4 * 3 * 12, "collective-permute": 2 * 24}
    M.all_gather(x, CPU)  # no receiving shard: every slab
    assert M.wire_bytes()["all-gather"] == 7 * 24
    M.reset_wire_bytes()
    assert set(M.wire_bytes().values()) == {0}
    assert tuple(M.wire_bytes()) == M.WIRE_KINDS


# -- launch.sharding: place and global_view ------------------------------------------


def _place(cfg, variant, mesh, params, cache):
    return PL.place(cfg, mesh, params, cache, manual=variant == "manual")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_place_then_gather_gives_every_leaf_back(variant, mesh_name):
    cfg = _cfg()
    mesh = _mesh(mesh_name)
    params = TF.init_params(0, cfg, device="cpu")
    cache = _fill(_cache(cfg, variant, mesh), seed=1)
    pp, pc = _place(cfg, variant, mesh, params, cache)
    for tree, placed_tree in ((params, pp), (cache, pc)):
        back = SR.global_view(placed_tree)
        got, want = _leaves(back), _leaves(tree)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        # the mesh lies on the trees' device: every slab is a view of its leaf
        roots = {w.untyped_storage().data_ptr() for w in want}
        assert all(t.untyped_storage().data_ptr() in roots for t in placed_tree.tensors())


def test_place_copies_to_other_devices_once_a_device():
    """A (2, 2) mesh whose stage 1 lies on ``meta``: stage 0's slabs are
    views of the CPU tree, stage 1's are copies on ``meta``, and the two
    ranks of a stage share one tensor where the spec replicates the leaf
    (wk) and hold their own columns where it splits it (wq)."""
    cfg = _cfg()
    mesh = LM.make_host_mesh((2, 2), devices=["cpu", "cpu", "meta", "meta"])
    params = TF.init_params(0, cfg, device="cpu")
    cache = PM.init_kv_cache(cfg, B, T, tp=2, device="cpu")
    pp, pc = PM.place(cfg, mesh, params, cache)
    for s, dev in ((0, "cpu"), (1, "meta")):
        ranks = [pp.at((s, r))["blocks"]["layer0"]["attn"] for r in range(2)]
        assert ranks[0]["wk"] is ranks[1]["wk"] and ranks[0]["wq"] is not ranks[1]["wq"]
        assert all(t.device.type == dev for r in ranks for t in tree_leaves(r))
        assert ranks[0]["wq"].shape[-1] == cfg.num_heads * cfg.hd // 2
        kv = [pc.at((s, r))["k"] for r in range(2)]
        assert kv[0].shape[0] == cfg.num_groups // 2 and kv[0].shape[3] == PM.kv_per_rank(cfg, 2)
    wk = params["blocks"]["layer0"]["attn"]["wk"]
    assert pp.at((0, 0))["blocks"]["layer0"]["attn"]["wk"].untyped_storage().data_ptr() == \
        wk.untyped_storage().data_ptr()
    meta = [t for t in pp.tensors() + pc.tensors() if t.device.type == "meta"]
    # every meta slab is its own tensor, and there are exactly as many as blocks:
    # per leaf, one for a replicated leaf, two for a leaf split over `model`
    counts = []
    SR.map_specs(lambda _p, _x, spec: counts.append(2 if "model" in spec else 1),
                 params, PM.param_shardings(cfg, mesh, params))
    # k, v and their scales split over `model`, two slabs each; index one
    assert len(meta) == sum(counts) + 4 * 2 + 1


@pytest.mark.parametrize("manual", [False, True], ids=["auto", "manual"])
def test_a_global_tree_for_a_mesh_over_other_devices_raises(manual):
    cfg = _cfg()
    params = TF.init_params(0, cfg, device="cpu")
    mesh = LM.make_host_mesh((2, 2), devices=["cpu", "cpu", "meta", "meta"])
    step = PL.build_pipeline_step(cfg, mesh, manual=manual)
    cache = _cache(cfg, "manual" if manual else "auto_plain", mesh)
    tok = torch.arange(1, B + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="serve.pipeline.place"):
        step(params, tok, cache)
    # trees placed over another mesh are refused too
    other = _mesh("2x2")
    pp, pc = PL.place(cfg, other, params, cache, manual=manual)
    with pytest.raises(ValueError, match="was placed over"):
        step(pp, tok, pc)


# -- the steps on placed trees ---------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placed_run_equals_the_global_run(variant, mesh_name):
    """Placed once, then stepped: the global run's tokens, and its cache bit
    for bit once gathered; the global cache handed to the placing is left
    as the placed run wrote it (the slabs are views)."""
    cfg = _cfg()
    mesh = _mesh(mesh_name)
    params = TF.init_params(0, cfg, device="cpu")
    step = PL.build_pipeline_step(cfg, mesh, manual=variant == "manual")
    want_tok, want = _drive(step, params, _cache(cfg, variant, mesh), steps=3)
    cache = _cache(cfg, variant, mesh)
    pp, pc = _place(cfg, variant, mesh, params, cache)
    got_tok, back = _drive(step, pp, pc, steps=3)
    assert back is pc
    assert torch.equal(got_tok, want_tok)
    for g, c, w in zip(_leaves(SR.global_view(pc)), _leaves(cache), _leaves(want)):
        assert torch.equal(g, w) and torch.equal(c, w)


def test_manual_rank_slab_holds_its_kv_heads():
    """8/4 heads at tp=2 (two KV heads a rank): rank r's placed slab holds
    exactly the heads ``kv_heads`` gives it, as the int8 serve step's cache
    holds them (one int8 level, scales 1e-5 relative)."""
    cfg = _cfg(num_heads=8, num_kv_heads=4, head_dim=16)
    tp, kvr = 2, PM.kv_per_rank(cfg, 2)
    mesh = _mesh("2x2")
    params = TF.init_params(0, cfg, device="cpu")
    step = PL.build_pipeline_step(cfg, mesh, manual=True)
    pp, pc = PM.place(cfg, mesh, params, PM.init_kv_cache(cfg, B, T, tp=tp, device="cpu"))
    serve = ST.build_serve_step(cfg)
    want = TF.init_cache(cfg, B, T, kv_quant=True, device="cpu")
    tok = torch.arange(1, B + 1, dtype=torch.int32)
    for _ in range(4):
        nxt, pc = step(pp, tok, pc)
        ref, want = serve(params, tok, want)
        assert torch.equal(nxt, ref)
        tok = ref
    heads = PM.kv_heads(cfg, tp)
    per = cfg.num_groups // 2
    mix = want["layer0"]["mixer"]
    for s in range(2):
        for r in range(tp):
            slab = pc.at((s, r))
            mine = heads[r * kvr:(r + 1) * kvr]
            assert slab["k"].shape[3] == kvr == len(mine)
            groups = slice(s * per, (s + 1) * per)
            for k in ("k", "v"):
                w = mix[k][groups][:, :, :, mine]
                assert int((slab[k].int() - w.int()).abs().max()) <= 1
            for k in ("k_scale", "v_scale"):
                torch.testing.assert_close(slab[k], mix[k][groups][:, :, :, mine],
                                           rtol=1e-5, atol=0)


# -- the bytes a step moves between shards ---------------------------------------------


def _expected_wire(cfg, mesh, manual: bool) -> dict:
    """The bytes one step moves between shards, from the rotation alone:
    the activation hops (one a lane), the emits' psum (one a lane), the
    head's partial logits (auto: psum over the stages holding lm_head's
    rows; manual: each rank's vocabulary columns gathered on rank 0), and in
    the manual variant the two psums of every layer, the embedding's gather
    and the pods' tokens."""
    s_n, tp = mesh.shape["data"], mesh.shape["model"]
    pods = mesh.shape.get("pod", 1) if manual else 1
    lanes = tp if manual else 1
    b_pod = B // pods
    mb = b_pod // s_n
    d, v = cfg.d_model, cfg.vocab_size
    isz = torch.tensor([], dtype=cfg.dtype()).element_size()
    act = mb * d * isz
    out = dict.fromkeys(M.WIRE_KINDS, 0)
    out["collective-permute"] = pods * lanes * (2 * s_n - 1) * s_n * act if s_n > 1 else 0
    out["all-reduce"] = pods * lanes * 2 * (s_n - 1) * s_n * act
    if manual:
        out["all-reduce"] += pods * (2 * s_n - 1) * cfg.num_groups * 2 * 2 * (tp - 1) * act
        out["all-gather"] = pods * ((tp - 1) * b_pod * d * isz + (tp - 1) * b_pod * (v // tp) * isz)
        out["all-gather"] += (pods - 1) * b_pod * 4
    elif d % s_n == 0 and s_n > 1:
        out["all-reduce"] += 2 * (s_n - 1) * B * v * 4
    return out


def _step_wire(cfg, mesh, manual, t_len=T):
    params = TF.init_params(0, cfg, device="cpu")
    variant = "manual" if manual else "auto_plain"
    pp, pc = PL.place(cfg, mesh, params, _cache(cfg, variant, mesh, t_len), manual=manual)
    step = PL.build_pipeline_step(cfg, mesh, manual=manual)
    tok = torch.arange(1, B + 1, dtype=torch.int32)
    tok, pc = step(pp, tok, pc)
    M.reset_wire_bytes()
    step(pp, tok, pc)
    return M.wire_bytes()


@pytest.mark.parametrize("manual", [False, True], ids=["auto", "manual"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_wire_bytes_a_step_follow_the_rotation(manual, mesh_name):
    """The tally equals the count from the rotation, and doubling the cache
    or the layers a stage holds moves no weight or cache byte between shards:
    the auto variant's bytes stay the same, the manual one's grow only by
    its two psums a layer."""
    cfg = _cfg()
    mesh = _mesh(mesh_name)
    base = _step_wire(cfg, mesh, manual)
    assert base == _expected_wire(cfg, mesh, manual)
    assert _step_wire(cfg, mesh, manual, t_len=2 * T) == base
    deep = _cfg(num_layers=2 * SHAPE["num_layers"])
    got = _step_wire(deep, mesh, manual)
    assert got == _expected_wire(deep, mesh, manual)
    if not manual:
        assert got == base
    else:
        assert {k: got[k] for k in got if k != "all-reduce"} == \
            {k: base[k] for k in base if k != "all-reduce"}


def test_global_run_on_one_device_moves_the_same_bytes():
    """Placing inside the step (a global tree) is the same path: the same
    tally as the placed run."""
    cfg = _cfg()
    mesh = _mesh("2x2")
    for manual in (False, True):
        params = TF.init_params(0, cfg, device="cpu")
        step = PL.build_pipeline_step(cfg, mesh, manual=manual)
        cache = _cache(cfg, "manual" if manual else "auto_plain", mesh)
        M.reset_wire_bytes()
        step(params, torch.arange(1, B + 1, dtype=torch.int32), cache)
        assert M.wire_bytes() == _expected_wire(cfg, mesh, manual)


def test_index_advances_once_a_step_on_every_placed_slab():
    """With pods, the four positions of a stage share its one index slab
    (the spec replicates it over `pod` and `model`): it advances once a
    step, not once a position."""
    cfg = _cfg()
    mesh = _mesh("pod2x2x2")
    params = TF.init_params(0, cfg, device="cpu")
    pp, pc = PM.place(cfg, mesh, params, PM.init_kv_cache(cfg, B, T, tp=2, device="cpu"))
    assert len({id(pc.at(c)["index"]) for c in pc.coords}) == 2
    _drive(PL.build_pipeline_step(cfg, mesh, manual=True), pp, pc, steps=3)
    for c in pc.coords:
        assert pc.at(c)["index"].tolist() == [3] * (cfg.num_groups // 2)
