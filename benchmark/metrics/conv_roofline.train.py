"""conv_roofline.train: the sum of a step's convolution bounds, forward,
input gradient and weight gradient (each the larger of its operations at
the bf16 peak and its bytes at HBM's rate, on the reference's direct
path), over the device time a step of the ``aten::convolution`` and
``aten::convolution_backward`` ops and their children in the profiled
stretch.  Read only where every such op in the profile carries its
kernels."""

NAME = "conv_roofline.train"


def read(ctx):
    t = ctx.trace
    seconds, calls, empty = t.op_device_s(
        ["aten::convolution", "aten::convolution_backward"])
    if not calls or empty or calls % t.items:
        ctx.missing(NAME, f"{calls} convolutions, {empty} without device "
                    f"time, over {t.items} steps")
        return None
    batch = ctx.config["train"]["batch_size"]
    bound = ctx.reference_counts(batch, True)["conv_bound_s"]
    return 100.0 * bound / (seconds / t.items)
