"""conv_roofline.swin: the sum of a volume's Swin UNETR convolution bounds
(each the larger of its operations at the bf16 peak and its bytes at HBM's
rate; ``reference/swin_unetr_counts.py``) over the device time a volume of
the ``aten::convolution`` ops and their children in the profiled stretch.
Read only where every such op in the profile carries its kernels."""

from benchmark.reference.swin_unetr_counts import counts_of

NAME = "conv_roofline.swin"


def read(ctx):
    t = ctx.trace
    seconds, calls, empty = t.op_device_s(["aten::convolution"])
    if not calls or empty or calls % t.items:
        ctx.missing(NAME, f"{calls} convolutions, {empty} without device "
                    f"time, over {t.items} volumes")
        return None
    return 100.0 * counts_of(ctx)["conv_bound_s"] / (seconds / t.items)
