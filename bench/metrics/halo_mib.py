"""Bytes that crossed between shards in a gossip round, averaged over the
window's rounds, from the program's own tally (``core.mesh.wire_bytes``):
the halo's ring steps and all-gathers; the evaluation's all-reduces are
not the mix's."""

HALO_KINDS = ("collective-permute", "all-gather")


def read(ctx):
    moved = sum(ctx.wire.get(k, 0) for k in HALO_KINDS)
    if not moved or not ctx.window["gossip_rounds"]:
        return None
    return moved / ctx.window["gossip_rounds"] / 2**20
