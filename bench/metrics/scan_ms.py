"""The selective scan kernels' card milliseconds a round: the device trace
of one further call of the cell under ``torch.profiler`` (graph replays
carry no host spans, so the kernels are found by name: ``scan_fwd`` and
``scan_bwd``), summed and divided by the call's rounds. It holds the
forward, its recompute and the backward of every member's Mamba layers,
and the forward of each recorded round's evaluation, if the traffic
records any (``bench/kinds/lm.py``)."""

from bench.kinds import lm


def read(ctx):
    got = lm.device_ms_by_kernel(ctx)
    if got is None:
        return None
    ms, rounds = got
    total = sum(v for k, v in ms.items() if any(name in k for name in lm.SCAN_KERNELS))
    return total / rounds if total > 0 else None
