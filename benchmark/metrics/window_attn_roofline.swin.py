"""window_attn_roofline.swin: K8's bound over a volume's window attention
calls (q, k, v read and the output written once at HBM's rate, or the
4 N^2 D flops a (window, head) at the bf16 peak, the larger, summed;
``reference/swin_unetr_counts.py``) over K8's device time a volume in the
profiled stretch.  Read only where the profile holds as many K8 kernels as
the port's counter moved over the stretch (``ctx.program_launches``)."""

from benchmark.reference.swin_unetr_counts import counts_of

NAME = "window_attn_roofline.swin"
KERNEL = r"\bwindow_attention_kernel\b"


def read(ctx):
    t = ctx.trace
    times = t.kernels(KERNEL)
    launched = getattr(ctx, "program_launches", {}).get(
        "fused_window_attention", 0)
    if not launched:
        ctx.missing(NAME, "the stretch launched no K8 kernel")
        return None
    if len(times) != launched:
        ctx.missing(NAME, f"the profile holds {len(times)} of the "
                    f"{launched} K8 launches")
        return None
    return 100.0 * counts_of(ctx)["window_bound_s"] / (sum(times) / t.items)
