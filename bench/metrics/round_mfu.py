"""The rounds' model FLOPs over the window's time, as a share of the card's
published float32 peak (TF32 is off) times the cell's cards
(``bench/counts.py`` counts them: local steps, evaluations and mixes)."""

from bench import counts


def read(ctx):
    if ctx.peaks is None:
        return None
    inp, tr, win = ctx.inputs, ctx.cell.traffic, ctx.window
    flops = counts.window_flops(
        p=ctx.param_count, batch=inp.batch, steps=inp.steps, n=inp.graph.n,
        test=len(inp.ds.y_test), nnz=inp.graph.nnz, rounds=win["rounds"],
        evals=win["evals"], gossip_rounds=win["gossip_rounds"])
    return 100.0 * flops / win["seconds"] / (ctx.peaks["f32_flops_per_s"] * ctx.cell.chips)
