"""Every round the window completed over the window's time, as
``rounds_per_s`` takes it: reported per layer in the four-card cell, whose
rate spreads between processes by more than an end-to-end bound may allow
(PERF.md, section 2)."""


def read(ctx):
    win = ctx.window
    if not win["seconds"]:
        return None
    return win["rounds"] / win["seconds"]
