"""Pipeline-parallel decode: the entry point.

The port of ``repro/serve/pipeline.py``. The mesh's `data` axis is a
pipeline axis: stage s owns layer groups [s*G/S, (s+1)*G/S) and their cache,
and activations rotate through the stages (``serve/gpipe.py``). The batch
is split into S microgroups rotated GPipe-style; one call advances every
sequence in the batch by one token.

Two variants share that rotation; ``build_pipeline_step(cfg, mesh,
manual=...)`` is the one documented entry point:

- ``manual=False`` (``build_pipeline_serve_step``): the stage axis is
  explicit; tensor parallelism inside a stage is the reference's
  auto-partitioner's, so here each stage runs its groups whole on the
  device of its first `model` position.
- ``manual=True`` (``pipeline_manual.build_manual_pipeline_step``):
  hand-written megatron TP over `model` with a per-rank int8 KV cache.

Both run on a ``core.mesh.Mesh``, one process driving every position.
``place(cfg, mesh, params, cache, manual=...)`` puts each position's slabs
of the params and the cache on its device once (``launch.sharding.place``,
as ``jax.device_put`` under the variant's shardings), and the step runs on
those placed trees for as long as they are used: it moves only the
activations between stages (``ppermute``), the emits' ``psum``, the head's
partial logits and, in the manual variant, the TP partial sums (``psum``)
and the embedding gather, all through ``core.mesh``'s collectives. The
step also takes the global trees of ``transformer.decode_step`` (the
params, the cache) where every position lies on their device: it places
them inside the step, as views, so the cache advances in place. A global
tree for a mesh over other devices raises ``ValueError``: place it first.
The head (final norm and ``lm_head``) runs after the rotation, outside the
stages, on the positions that hold ``lm_head``'s slabs.

Constraints: uniform layer pattern (period tiles the stack), num_groups %
stages == 0, decoder-only (no cross-attention), batch % stages == 0.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import mesh as mesh_mod
from repro_torch.launch import sharding as SR
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.serve import gpipe
from repro_torch.tree import tree_leaves, tree_map_with_path

__all__ = ["build_pipeline_step", "stage_shardings", "build_pipeline_serve_step", "place",
           "stage_mesh"]

PyTree = Any


def build_pipeline_step(cfg: ArchConfig, mesh, *, manual: bool = False, **kw) -> Callable:
    """One documented entry point for both pipeline-decode variants.

    Returns serve_step(params, token (B,), cache) -> (next_token, cache),
    the params and the cache as ``place`` gives them (or global trees on the
    mesh's one device); the cache comes back as it was given, advanced in
    place. ``manual=False`` takes ``transformer.init_cache``'s cache (plain
    or int8); ``manual=True`` takes ``pipeline_manual.init_kv_cache``'s
    (int8, per-rank KV heads).
    """
    if manual:
        from repro_torch.serve import pipeline_manual as PM

        return PM.build_manual_pipeline_step(cfg, mesh, **kw)
    return build_pipeline_serve_step(cfg, mesh, **kw)


def stage_shardings(cfg: ArchConfig, mesh, *, batch: int, kv_quant: bool):
    """(param shapes on ``meta``, param specs, cache specs): the blocks'
    group axis over `data` (pipeline stages), TP dims over `model`; the
    cache's group axis over `data`, its seq dim over `model`."""
    params = TF.init_params(0, cfg, device="meta")

    def param_sh(path, leaf):
        pstr = SR._path_str(path)
        spec = list(SR.leaf_spec(pstr, tuple(leaf.shape), cfg, mesh, has_node_axis=False))
        if pstr.startswith("blocks/"):
            # drop any `data` FSDP the generic rule chose; the stage axis owns it
            spec = [s if s not in ("data", ("data",)) else None for s in spec]
            spec[0] = "data"
        return SR.P(*spec)

    p_sh = tree_map_with_path(param_sh, params)
    cache = TF.init_cache(cfg, batch, 1, kv_quant=kv_quant, device="meta")

    def cache_sh(path, leaf):
        pstr = SR._path_str(path)
        spec = [None] * leaf.ndim
        if leaf.ndim >= 1 and not pstr.endswith("index"):
            spec[0] = "data"  # group-stack axis = pipeline stage
        if (pstr.endswith("/k") or pstr.endswith("/v")) and leaf.ndim >= 3:
            if leaf.shape[2] % mesh.shape.get("model", 1) == 0:
                spec[2] = "model"  # cache seq dim
        return SR.P(*spec)

    return params, p_sh, tree_map_with_path(cache_sh, cache)


def place(cfg: ArchConfig, mesh, params: PyTree, cache: PyTree, *,
          manual: bool = False) -> tuple[SR.Placed, SR.Placed]:
    """The params and the cache placed once over ``mesh`` for the variant's
    step (``build_pipeline_step(cfg, mesh, manual=manual)``): each
    position's slabs on its device. Give global trees on one device (the
    CPU, say); where that device is a position's the slab is a view, so a
    global tree on a card the mesh uses stays alive through its views.
    ``launch.sharding.global_view`` gives the global cache back."""
    if manual:
        from repro_torch.serve import pipeline_manual as PM

        return PM.place(cfg, mesh, params, cache)
    smesh = stage_mesh(mesh)
    return (SR.place(params, _param_specs(cfg, mesh), smesh),
            SR.place(cache, _cache_specs(cache), smesh))


def stage_mesh(mesh, stages: int | None = None) -> mesh_mod.Mesh:
    """The auto variant's (S, 1) mesh ("data", "model"): stage s on the
    device of its first `model` position (of pod 0), where it runs whole."""
    devs = mesh.shard_devices("data")[:stages or mesh.shape["data"]]
    grid = np.empty((len(devs), 1), dtype=object)
    grid[:, 0] = devs
    return mesh_mod.Mesh(grid, ("data", "model"))


def _param_specs(cfg: ArchConfig, mesh) -> PyTree:
    return stage_shardings(cfg, mesh, batch=1, kv_quant=False)[1]


def _cache_specs(cache: PyTree) -> PyTree:
    """The stage mesh's cache specs: every leaf's group axis over `data`,
    ``index`` included, as the reference's ``shard_map`` in_specs split it
    (``stage_shardings`` replicates ``index``); `model` has one position."""
    return tree_map_with_path(lambda _p, _x: SR.P("data"), cache)


def placed(tree: PyTree, specs, mesh, what: str) -> SR.Placed:
    """``tree`` if it was placed over ``mesh``'s devices; a global tree
    placed as views where every position lies on its device; else
    ``ValueError``."""
    if isinstance(tree, SR.Placed):
        if tree.mesh.devices.shape != mesh.devices.shape or any(
                not mesh_mod.same_device(a, b)
                for a, b in zip(tree.mesh.devices.ravel(), mesh.devices.ravel())):
            raise ValueError(f"{what} was placed over {tree.mesh}, the step runs over {mesh}")
        return tree
    devs = {leaf.device for leaf in tree_leaves(tree) if leaf is not None}
    if any(not mesh_mod.same_device(d, p) for d in devs for p in mesh.device_set):
        raise ValueError(
            f"the global {what} lies on {sorted(map(str, devs))} and the mesh's positions on "
            f"{sorted(map(str, mesh.device_set))}: place it first with "
            f"repro_torch.serve.pipeline.place(cfg, mesh, params, cache, manual=...)")
    return SR.place(tree, specs(tree) if callable(specs) else specs, mesh)


def _is_index(path) -> bool:
    return str(path[-1]) == "index"


def build_pipeline_serve_step(
    cfg: ArchConfig,
    mesh,
    *,
    stages: int | None = None,
    window: int | None = None,
) -> Callable:
    """Auto-partitioned-TP variant; prefer ``build_pipeline_step``. As in
    the reference, ``window`` is passed to the layers as given (the config's
    ``always_window`` default is not applied)."""
    stages = stages or mesh.shape["data"]
    if cfg.num_groups % stages:
        raise ValueError(f"{cfg.arch_id}: {cfg.num_groups} groups % {stages} stages != 0")
    if cfg.enc_dec:
        raise ValueError("pipeline decode supports decoder-only models")
    per_stage = cfg.num_groups // stages
    smesh = stage_mesh(mesh, stages)
    devices = [smesh.devices[s, 0] for s in range(stages)]
    p_specs = _param_specs(cfg, mesh)

    @torch.no_grad()
    def serve_step(params: PyTree, token: torch.Tensor, cache: PyTree):
        b = token.shape[0]
        mb = b // stages
        pp = placed(params, p_specs, smesh, "params")
        pc = placed(cache, _cache_specs, smesh, "cache")
        at = [pp.at((s, 0)) for s in range(stages)]
        caches = [pc.at((s, 0)) for s in range(stages)]
        # the token is the step's input, replicated to the stage that embeds
        x_groups = at[0]["embed"][token.to(devices[0])].reshape(stages, mb, 1, -1)

        def apply_local(s, x, sub):
            (x,) = x  # the stage's one lane
            for j in range(per_stage):
                x, _, _ = TF._apply_group(
                    TF._at(at[s]["blocks"], j), x, cfg, window=window, cache=TF._at(sub, j),
                    cross=None, memory=None, positions=None,
                )
            return [x], sub  # the layers advanced ``sub`` in place

        # index leaves are shared by the microgroups: they pass through the
        # slice and write untouched and are bumped once per serve_step
        xs = gpipe.rotate(
            [x_groups], caches, stages=stages,
            apply_fn=apply_local,
            slice_fn=lambda c, m: gpipe.microbatch_slice(c, m, mb, skip=_is_index),
            write_fn=lambda c, new, m, act: gpipe.microbatch_write(
                c, new, m, mb, act, skip=_is_index),
            devices=[[d] for d in devices],
        )
        xs = [x for (x,) in xs]
        for c in caches:
            tree_map_with_path(lambda p, x: x.add_(1) if _is_index(p) else x, c)
        # the head, outside the stages, where lm_head's rows lie: split over
        # the stages (the spec's `data`), each stage's part of the logits in
        # f32, summed by psum; else whole on every stage, run on stage 0
        blk = at[0]["lm_head"].shape[0]
        if blk == cfg.d_model:
            logits = (L.norm(xs[0], at[0]["final_norm"], cfg.norm) @ at[0]["lm_head"]).float()
        else:
            parts = [(L.norm(x, a["final_norm"], cfg.norm)[:, s * blk:(s + 1) * blk]
                      @ a["lm_head"]).float() for s, (x, a) in enumerate(zip(xs, at))]
            logits = mesh_mod.psum(parts, devices)[0]
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step
