"""Share of a call in which a card ran nothing, averaged over the cell's
cards: the device's busy seconds in one traced call (the profiler's device
trace, CUPTI) over the median untraced call of the window. The profiler's
host-side recording slows a host-bound call (nearly twice as long in the
sharded cells), so the traced call's own length would count the profiler's
overhead as idle; the card's busy time does not grow with it. Where the
traced call's busy time exceeds the untraced median, the traced call's
length is the base. A trace with no device activity gives no reading."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s:
        return None
    busy = ctx.trace.mean_busy_s(ctx.cell.chips)
    base = ctx.window["median_call_s"]
    if busy > base:
        base = ctx.trace.window_s
    return 100.0 * (1.0 - busy / base)
