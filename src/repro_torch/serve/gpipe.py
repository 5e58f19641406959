"""GPipe stage rotation shared by the pipeline-parallel decode variants.

The port of ``repro/serve/gpipe.py``. Both pipeline serving layouts
(``serve/pipeline.py``, ``serve/pipeline_manual.py``) drive one schedule:
the batch splits into S microgroups, stage 0 injects microgroup t at tick t,
finished microgroups leave from the last stage, activations hop stage ->
stage+1 via ``ppermute``, and 2S-1 ticks drain the whole batch. The two
variants differ only in what one stage does to its activations and cache.

The reference runs every stage at once (SPMD under ``shard_map``); the port
runs them one after another in one process, each on its own device (or one
device for all), in lockstep: at tick t every
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
  microgroup's activations (a replica a lane) and its cache slice.
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
    x_groups: list[torch.Tensor],
    caches: list[PyTree],
    *,
    stages: int,
    apply_fn: Callable[[int, list[torch.Tensor], PyTree], tuple[list[torch.Tensor], PyTree]],
    slice_fn: Callable[[PyTree, int], PyTree],
    write_fn: Callable[[PyTree, PyTree, int, bool], Any],
    devices: list[list[torch.device]],
) -> list[list[torch.Tensor]]:
    """Run the full 2S-1-tick GPipe rotation over the S stages.

    A stage holds one or more lanes, each with its own replica of the
    activations, as every TP rank of a stage holds them in the reference
    (the auto variant runs a stage whole: one lane). ``devices[s]``: stage
    s's device of each lane. x_groups: stage 0's embedded microgroups, one
    (S, mb, 1, d) tensor a lane, on its lane's device. ``caches``: each
    stage's cache, updated in place. ``apply_fn(s, x, sub)`` takes and
    returns a list of replicas, one a lane; each lane hops to the same lane
    of the next stage. Returns each stage's xs (S*mb, d) a lane, every
    microgroup's output in order on that lane's device: the reference's
    ``psum`` of the zero-filled emits over the stage axis, added in stage
    order, which every stage receives.
    """
    n_lanes = len(devices[0])
    lane_devs = [[devices[s][lane] for s in range(stages)] for lane in range(n_lanes)]
    x_cur = [[torch.zeros_like(x_groups[lane][0], device=d) for lane, d in enumerate(devs)]
             for devs in devices]
    emits: list[list[list[torch.Tensor]]] = []  # [tick][stage][lane]
    for t in range(2 * stages - 1):
        outs, tick_emits = [], []
        for s in range(stages):
            # microgroup handled by stage s at tick t (GPipe rotation)
            m = t - s
            active = 0 <= m < stages
            m_c = min(max(m, 0), stages - 1)
            x = x_cur[s]
            if s == 0 and t < stages:  # stage 0 injects microgroup t
                x = [xg[t] for xg in x_groups]
            y, sub_new = apply_fn(s, x, slice_fn(caches[s], m_c))
            keep = float(active)
            x_out = [yl * keep + xl * (1 - keep) for yl, xl in zip(y, x)]
            write_fn(caches[s], sub_new, m_c, active)
            outs.append(x_out)
            # finished microgroups leave the last stage BEFORE the permute
            done = s == stages - 1 and active
            tick_emits.append(x_out if done else [torch.zeros_like(o) for o in x_out])
        # every stage has computed tick t: only now do activations move on,
        # each lane to the same lane of the next stage
        pairs = [(i, (i + 1) % stages) for i in range(stages)]
        moved = [mesh_mod.ppermute([outs[s][lane] for s in range(stages)], pairs, devs)
                 for lane, devs in enumerate(lane_devs)]
        x_cur = [[moved[lane][s] for lane in range(n_lanes)] for s in range(stages)]
        emits.append(tick_emits)
    # microgroup m finished at tick m + S - 1 on the last stage
    rows = stages * x_groups[0].shape[1]
    xs = []
    for lane, devs in enumerate(lane_devs):
        per_stage = [torch.stack([emits[m + stages - 1][s][lane][:, 0, :]
                                  for m in range(stages)]) for s in range(stages)]
        xs.append([x.reshape(rows, -1) for x in mesh_mod.psum(per_stage, devs)])
    return [[xs[lane][s] for lane in range(n_lanes)] for s in range(stages)]
