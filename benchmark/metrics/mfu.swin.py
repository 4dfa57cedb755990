"""mfu.swin: the logical operations of a volume's B=8 Swin UNETR forward,
counted once on the reference (``reference/swin_unetr_counts.py``), over
the measured window's time a volume, as a share of the card's dense bf16
peak."""

from benchmark.reference.swin_unetr_counts import BF16_FLOPS, counts_of


def read(ctx):
    return 100.0 * counts_of(ctx)["flops"] / ctx.per_item_s() / BF16_FLOPS
