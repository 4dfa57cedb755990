"""k1_roofline.serve: the byte bound of a volume's 32 fused-norm sites (the
input and residual read once, the output written once, at HBM's rate)
over K1's device time a volume in the profiled stretch.  Read only where
the profile holds every K1 launch the port's counter made."""

from benchmark.trace import COUNTERS

NAME = "k1_roofline.serve"


def read(ctx):
    t = ctx.trace
    times = t.kernels(COUNTERS["fusednorm"][1])
    launched = t.launches["fusednorm"]
    if not launched:
        ctx.missing(NAME, "the stretch launched no K1 kernel")
        return None
    if len(times) != launched:
        ctx.missing(NAME, f"the profile holds {len(times)} of the "
                    f"{launched} K1 launches")
        return None
    bound = ctx.reference_counts(8, False)["k1_bound_s"]
    return 100.0 * bound / (sum(times) / t.items)
