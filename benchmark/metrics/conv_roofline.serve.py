"""conv_roofline.serve: the sum of a volume's convolutions' bounds (each the
larger of its operations at the bf16 peak and its bytes at HBM's rate, on
the reference's direct path) over the device time a volume of the
``aten::convolution`` ops and their children in the profiled stretch.
Read only where every such op in the profile carries its kernels."""

NAME = "conv_roofline.serve"


def read(ctx):
    t = ctx.trace
    seconds, calls, empty = t.op_device_s(["aten::convolution"])
    if not calls or empty or calls % t.items:
        ctx.missing(NAME, f"{calls} convolutions, {empty} without device "
                    f"time, over {t.items} volumes")
        return None
    bound = ctx.reference_counts(8, False)["conv_bound_s"]
    return 100.0 * bound / (seconds / t.items)
