"""k1_roofline.swin: the byte bound of a volume's 26 Swin UNETR norm sites
(the input, and at the last norm of each residual block the residual, read
once, the output written once, at HBM's rate;
``reference/swin_unetr_counts.py``) over K1's device time a volume in the
profiled stretch.  Read only where the profile holds every K1 launch the
port's counter made."""

from benchmark.reference.swin_unetr_counts import counts_of
from benchmark.trace import COUNTERS

NAME = "k1_roofline.swin"


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
    return 100.0 * counts_of(ctx)["k1_bound_s"] / (sum(times) / t.items)
