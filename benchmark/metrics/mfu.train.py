"""mfu.train: the logical operations of a step's forward, loss and
backward at the configuration's batch, counted on the reference's direct
path, over the measured window's time a step, as a share of the card's
dense bf16 peak."""

from benchmark.reference.counts import BF16_FLOPS


def read(ctx):
    batch = ctx.config["train"]["batch_size"]
    flops = ctx.reference_counts(batch, True)["flops"]
    return 100.0 * flops / ctx.per_item_s() / BF16_FLOPS
