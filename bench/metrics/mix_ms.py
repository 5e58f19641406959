"""One gossip round as ``run_fused`` stages it (``GossipEngine.program``),
on the cell's state after the window: the mix's captured graph, or on
``sparse_sharded`` each shard's send graph, the halo exchange and each
shard's rows graph. Run twice first (eagerly, then captured), then the
median of at least 20 replays: on one card each replay between CUDA events;
on several, groups of replays spanning 0.25 s or more on the host's clock,
ending in a synchronize of every card. No reading where the program no
longer stages its rounds this way; standard error then names the piece
that is gone."""

import statistics
import sys
import time

import torch

REPLAYS = 20


def _staged(ctx):
    from repro_torch.train import trainer as T

    tr = ctx.trainer
    program = tr.engine.program(1, kind=tr.mix_impl)
    steps = ctx.inputs.steps
    if program.kind == "sparse_sharded":
        run = T._ShardedFusedRounds(tr, program, steps)

        def once():
            for sh in run.shards:
                run._run(sh, ("send", 0), lambda sh=sh: run._send(sh, 0))
            run._exchange(0)
            for sh in run.shards:
                run._run(sh, ("rows", 0), lambda sh=sh: run._rows(sh, 0))
        return once, run.close
    run = T._FusedRounds(tr, program, steps)
    graphs = {}

    def once():
        T._run_piece(graphs, "mix", lambda: run._mix(0), run.device, run.stream, run.pool)
    return once, graphs.clear


def read(ctx):
    if ctx.devices[0].type != "cuda":
        return None
    try:
        once, close = _staged(ctx)
    except AttributeError as e:
        print(f"mix_ms: no reading, the program no longer stages its rounds as this "
              f"reader knows: {e}", file=sys.stderr)
        return None
    try:
        once()
        once()
        ctx.sync()
        if len(set(ctx.devices)) == 1:
            times = []
            for _ in range(REPLAYS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                once()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            return statistics.median(times)
        t0 = time.perf_counter()
        once()
        ctx.sync()
        group = max(1, int(0.25 / max(time.perf_counter() - t0, 1e-6)) + 1)
        means, done = [], 0
        while done < REPLAYS or len(means) < 3:
            t0 = time.perf_counter()
            for _ in range(group):
                once()
            ctx.sync()
            means.append(1e3 * (time.perf_counter() - t0) / group)
            done += group
        return statistics.median(means)
    finally:
        close()
