"""An LM cohort's model FLOPs over the window's time, as a share of the
card's published bf16 peak times the cell's cards: 6 P a token (forward 2 P,
backward 4 P) for each member's tokens of each round the window completed
(``bench/kinds/lm.py``'s inputs). The recompute under remat and the
cohort's evaluation are work the algorithm does not need: not counted."""


def read(ctx):
    tokens = getattr(ctx.inputs, "tokens_per_round", None)
    if ctx.peaks is None or not ctx.param_count or tokens is None or not ctx.window["seconds"]:
        return None
    flops = 6 * ctx.param_count * tokens * ctx.window["rounds"]
    return 100.0 * flops / ctx.window["seconds"] / (ctx.peaks["bf16_flops_per_s"] * ctx.cell.chips)
