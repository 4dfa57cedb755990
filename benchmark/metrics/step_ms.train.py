"""step_ms.train: the measured window over the steps it completed, a
synchronise at its end (host clock)."""


def read(ctx):
    return ctx.per_item_s() * 1e3
