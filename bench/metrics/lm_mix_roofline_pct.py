"""The least time an LM cohort's gossip round could take on the cell's cards
(``bench/kinds/lm.py``'s ``mix_work``: each member's parameters read and
written once in their dtypes and W's nonzeros read once, at the HBM rate,
or its multiply-adds at the f32 rate, whichever is larger, each peak times
the cell's cards), as a share of ``lm_mix_ms``. The same work is counted
whatever implements the mix (on ``sparse``, ``ell_sum`` a leaf)."""

from bench.kinds import lm


def read(ctx):
    ms = ctx.value("lm_mix_ms")
    if ms is None or ctx.peaks is None or not getattr(ctx.inputs, "member_bytes", 0):
        return None
    work, cards = lm.mix_work(ctx.inputs), ctx.cell.chips
    least = max(work["bytes"] / (ctx.peaks["hbm_bytes_per_s"] * cards),
                work["ops"] / (ctx.peaks["f32_flops_per_s"] * cards))
    return 100.0 * least / (ms / 1e3)
