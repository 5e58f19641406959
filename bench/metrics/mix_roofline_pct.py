"""The least time the mix could take on the cell's cards (its bytes over the
HBM bandwidth, or its FLOPs over the float32 peak, whichever is larger, each
peak times the cell's cards, over which the nodes' state is spread), as a
share of ``mix_ms``. The same work is counted whatever implements the mix."""

from bench import counts


def read(ctx):
    ms = ctx.value("mix_ms")
    if ms is None or ctx.peaks is None:
        return None
    n, p, nnz = ctx.inputs.graph.n, ctx.param_count, ctx.inputs.graph.nnz
    cards = ctx.cell.chips
    least = max(counts.mix_bytes(n, p, nnz) / (ctx.peaks["hbm_bytes_per_s"] * cards),
                counts.mix_flops(nnz, p) / (ctx.peaks["f32_flops_per_s"] * cards))
    return 100.0 * least / (ms / 1e3)
