"""One evaluation of every node on the test set (``eval_round``, as
``run_fused`` calls it, on the cell's state after the window: a sharded
cell's slabs on their cards), on the host's clock ending in a synchronize
of every card; evaluations are repeated until they span 0.3 s and the mean
is taken."""

import time

from repro_torch.core import mesh as mesh_mod
from repro_torch.tree import tree_leaves, tree_unflatten


def _slabs(ctx):
    tr = ctx.trainer
    if tr.mix_impl != "sparse_sharded":
        return None
    per_leaf = [mesh_mod.scatter(x, ctx.devices) for x in tree_leaves(tr.params)]
    return [tree_unflatten(tr.params, [p[s] for p in per_leaf]) for s in range(len(ctx.devices))]


def read(ctx):
    if ctx.devices[0].type != "cuda":
        return None
    tr, ds = ctx.trainer, ctx.inputs.ds
    slabs = _slabs(ctx)
    t_run = time.perf_counter()
    tr.eval_round(0, ds.x_test, ds.y_test, t_run, slabs=slabs)
    ctx.sync()
    n, t0 = 0, time.perf_counter()
    while n < 3 or time.perf_counter() - t0 < 0.3:
        tr.eval_round(0, ds.x_test, ds.y_test, t_run, slabs=slabs)
        ctx.sync()
        n += 1
    return 1e3 * (time.perf_counter() - t0) / n
