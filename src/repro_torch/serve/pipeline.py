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

Both take the same global-view trees as ``transformer.decode_step`` (the
params, a (B,) token, the cache) on a ``core.mesh.Mesh``, one process
driving every position. A stage's slab of a tree is a view of it where the
stage's device is the tree's, so its cache is advanced in place; on another
device it is a copy, written back after the step.

Constraints: uniform layer pattern (period tiles the stack), num_groups %
stages == 0, decoder-only (no cross-attention), batch % stages == 0.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.mesh import same_device
from repro_torch.launch import sharding as SR
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.serve import gpipe
from repro_torch.tree import tree_leaves, tree_map_with_path

__all__ = ["build_pipeline_step", "stage_shardings", "build_pipeline_serve_step"]

PyTree = Any


def build_pipeline_step(cfg: ArchConfig, mesh, *, manual: bool = False, **kw) -> Callable:
    """One documented entry point for both pipeline-decode variants.

    Returns serve_step(params, token (B,), cache) -> (next_token, cache).
    ``manual=False`` takes ``transformer.init_cache``'s cache (plain or
    int8); ``manual=True`` takes ``pipeline_manual.init_kv_cache``'s (int8,
    per-rank KV heads).
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


def _is_index(path) -> bool:
    return str(path[-1]) == "index"


def stage_slabs(tree: PyTree, s: int, per_stage: int, device) -> PyTree:
    """Groups [s*per_stage, (s+1)*per_stage) of a stacked tree on ``device``:
    views where the tree already lies there."""
    return tree_map_with_path(
        lambda _p, x: x.narrow(0, s * per_stage, per_stage).to(device), tree)


def write_back(tree: PyTree, slabs: list[PyTree], per_stage: int) -> None:
    """Copy each stage's slab back into the global ``tree`` where it is a
    copy on another device (a view already wrote through)."""
    for s, slab in enumerate(slabs):
        for full, part in zip(tree_leaves(tree), tree_leaves(slab)):
            if full is not None and not same_device(full.device, part.device):
                full.narrow(0, s * per_stage, per_stage).copy_(part)


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
    devices = mesh.shard_devices("data")[:stages]

    @torch.no_grad()
    def serve_step(params: PyTree, token: torch.Tensor, cache: PyTree):
        b = token.shape[0]
        mb = b // stages
        blocks = [stage_slabs(params["blocks"], s, per_stage, d) for s, d in enumerate(devices)]
        caches = [stage_slabs(cache, s, per_stage, d) for s, d in enumerate(devices)]
        embed = params["embed"].to(devices[0])
        x_groups = embed[token.to(devices[0])].reshape(stages, mb, 1, -1)  # (S, mb, 1, d)

        def apply_local(s, x, sub):
            for j in range(per_stage):
                x, _, _ = TF._apply_group(
                    TF._at(blocks[s], j), x, cfg, window=window, cache=TF._at(sub, j),
                    cross=None, memory=None, positions=None,
                )
            return x, sub  # the layers advanced ``sub`` in place

        # index leaves are shared by the microgroups: they pass through the
        # slice and write untouched and are bumped once per serve_step
        xs = gpipe.rotate(
            x_groups, caches, stages=stages,
            apply_fn=apply_local,
            slice_fn=lambda c, m: gpipe.microbatch_slice(c, m, mb, skip=_is_index),
            write_fn=lambda c, new, m, act: gpipe.microbatch_write(
                c, new, m, mb, act, skip=_is_index),
            devices=devices,
        )
        for c in caches:
            tree_map_with_path(lambda p, x: x.add_(1) if _is_index(p) else x, c)
        write_back(cache, caches, per_stage)
        xs = xs.to(params["final_norm"]["w"].device)
        h = L.norm(xs, params["final_norm"], cfg.norm)
        logits = (h @ params["lm_head"]).float()
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step
