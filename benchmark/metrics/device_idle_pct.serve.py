"""device_idle_pct.serve: the share of the profiled stretch in which no
kernel, copy or fill ran on the card."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
