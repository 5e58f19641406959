"""GPipe stage rotation shared by the pipeline-parallel decode variants.

The port of ``repro/serve/gpipe.py``. Both pipeline serving layouts
(``serve/pipeline.py``, ``serve/pipeline_manual.py``) drive one schedule:
the batch splits into S microgroups, stage 0 injects microgroup t at tick t,
finished microgroups leave from the last stage, activations hop stage ->
stage+1 via ``ppermute``, and 2S-1 ticks drain the whole batch. The two
variants differ only in what one stage does to its activations and cache.

The reference runs every stage at once (SPMD under ``shard_map``); the port
runs them one after another in one process, in lockstep: at tick t every
stage computes from its input of tick t, and only once all S outputs of the
tick are in does ``ppermute`` move them. As in the reference, every stage
computes on every tick, the warm-up and drain bubble included, and the
bubble's results are dropped. The port's layers update caches in place, so
``microbatch_slice`` hands the stage a copy of a microgroup's rows and
``microbatch_write`` copies them back only on an active tick: the bubble
never touches a real row, and a shared ``index`` counter (skipped by both)
is left for the caller to bump once per step.

Caller supplies three callbacks:

- ``apply_fn(s, x, sub) -> (y, sub_new)``: stage ``s``'s layer groups on one
  microgroup's activations and its cache slice.
- ``slice_fn(cache, m) -> sub``: microgroup m's rows of a stage cache.
- ``write_fn(cache, sub_new, m, active)``: write them back, in place, when
  ``active`` (the warm-up/drain bubble is not).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import mesh as mesh_mod
from repro_torch.tree import tree_map_with_path

__all__ = ["microbatch_slice", "microbatch_write", "rotate"]

PyTree = Any


def microbatch_slice(
    tree: PyTree, m: int, mb: int, *, axis: int = 1, skip: Callable | None = None
) -> PyTree:
    """A copy of rows [m*mb, (m+1)*mb) along ``axis`` of every leaf; leaves
    matching ``skip(path)`` (``path`` the tuple of keys) are copied whole
    (e.g. shared ``index`` counters)."""
    return tree_map_with_path(
        lambda p, leaf: leaf.clone()
        if (skip is not None and skip(p))
        else leaf.narrow(axis, m * mb, mb).clone(),
        tree,
    )


def microbatch_write(
    tree: PyTree,
    new: PyTree,
    m: int,
    mb: int,
    active: bool,
    *,
    axis: int = 1,
    skip: Callable | None = None,
) -> PyTree:
    """Write a microgroup's updated rows back into ``tree`` in place where
    ``active``; skipped leaves (and the bubble's inactive ticks) keep their
    old values. Returns ``tree``."""
    if not active:
        return tree

    def upd(p, full, sub_new):
        if not (skip is not None and skip(p)):
            full.narrow(axis, m * mb, mb).copy_(sub_new)
        return full

    tree_map_with_path(upd, tree, new)
    return tree


def rotate(
    x_groups: torch.Tensor,
    caches: list[PyTree],
    *,
    stages: int,
    apply_fn: Callable[[int, torch.Tensor, PyTree], tuple[torch.Tensor, PyTree]],
    slice_fn: Callable[[PyTree, int], PyTree],
    write_fn: Callable[[PyTree, PyTree, int, bool], Any],
    devices: list[torch.device],
) -> torch.Tensor:
    """Run the full 2S-1-tick GPipe rotation over the S stages.

    x_groups: (S, mb, 1, d), stage 0's embedded microgroups. ``caches``:
    each stage's cache, updated in place; ``devices``: each stage's device.
    Returns xs (S*mb, d), every microgroup's output in order, on
    ``devices[0]`` (the reference's ``psum`` of the zero-filled emits over
    the stage axis, added in stage order).
    """
    x_cur = [torch.zeros_like(x_groups[0], device=d) for d in devices]
    emits: list[list[torch.Tensor]] = []  # [tick][stage]
    for t in range(2 * stages - 1):
        outs, tick_emits = [], []
        for s in range(stages):
            # microgroup handled by stage s at tick t (GPipe rotation)
            m = t - s
            active = 0 <= m < stages
            m_c = min(max(m, 0), stages - 1)
            x = x_cur[s]
            if s == 0 and t < stages:  # stage 0 injects microgroup t
                x = x_groups[t].to(devices[0])
            y, sub_new = apply_fn(s, x, slice_fn(caches[s], m_c))
            keep = float(active)
            x_out = y * keep + x * (1 - keep)
            write_fn(caches[s], sub_new, m_c, active)
            outs.append(x_out)
            # finished microgroups leave the last stage BEFORE the permute
            done = s == stages - 1 and active
            tick_emits.append(x_out if done else torch.zeros_like(x_out))
        # every stage has computed tick t: only now do activations move on
        x_cur = mesh_mod.ppermute(outs, [(i, (i + 1) % stages) for i in range(stages)],
                                  devices)
        emits.append(tick_emits)
    # microgroup m finished at tick m + S - 1 on the last stage
    per_stage = [torch.stack([emits[m + stages - 1][s][:, 0, :] for m in range(stages)])
                 for s in range(stages)]  # each (S, mb, d)
    xs = mesh_mod.psum(per_stage, devices)[0]
    return xs.reshape(stages * x_groups.shape[1], -1)
