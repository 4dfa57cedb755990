"""mfu.serve: the logical operations of a volume's B=8 forward, counted
once on the reference's direct path, over the measured window's time a
volume, as a share of the card's dense bf16 peak."""

from benchmark.reference.counts import BF16_FLOPS


def read(ctx):
    flops = ctx.reference_counts(8, False)["flops"]
    return 100.0 * flops / ctx.per_item_s() / BF16_FLOPS
