"""engine_enqueue_ms.serve: host time of the engine's ``tiled_probs`` call
until it returns, mean a request of the measured window (the benchmark's
span ``engine``)."""


def read(ctx):
    d = ctx.spans.durations("engine", ctx.window["t0"], ctx.window["t1"])
    if not d:
        ctx.missing("engine_enqueue_ms.serve", "no engine span in the window")
        return None
    return sum(d) / len(d) * 1e3
