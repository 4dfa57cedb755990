"""loader_wait_ms.train: host time spent waiting for the trainer's next
device batch, mean a step of the measured window (the benchmark's span
``loader_wait``)."""


def read(ctx):
    d = ctx.spans.durations("loader_wait", ctx.window["t0"],
                            ctx.window["t1"])
    if not d:
        ctx.missing("loader_wait_ms.train", "no loader_wait span")
        return None
    return sum(d) / len(d) * 1e3
