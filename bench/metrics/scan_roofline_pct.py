"""The least time the selective scan's work of a round could take on the
card (its bytes at the HBM rate or its f32 operations at the f32 rate,
whichever is larger: ``bench/kinds/lm.py``'s ``scan_work``, counting the
forward, the recompute and the backward, and the forward of each recorded
round's evaluation, if any, whatever implements them), as a share of
``scan_ms``."""

from bench.kinds import lm


def read(ctx):
    ms = ctx.value("scan_ms")
    if ms is None or ctx.peaks is None:
        return None
    traffic = ctx.cell.traffic
    rounds = int(traffic["rounds_per_call"])
    work = lm.scan_work(ctx.inputs, rounds, lm.evals_per_call(traffic))
    least = max(work["bytes"] / ctx.peaks["hbm_bytes_per_s"],
                work["ops"] / ctx.peaks["f32_flops_per_s"]) / rounds
    return 100.0 * least / (ms / 1e3)
