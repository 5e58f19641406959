"""``round_mfu`` in the four-card cell, under a name of its own there: that
cell reports its rate per layer (``rounds_per_s.4card``), so this reading
names another end-to-end metric to move (PERF.md, section 3)."""


def read(ctx):
    return ctx.value("round_mfu")
