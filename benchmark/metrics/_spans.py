"""The readers of the program's spans (``dctseg_torch/utils/profiling.py``
``span``): one span's summed inclusive duration over the profiled
stretch's items, read only where the stretch holds one root span an item."""

SERVE_ROOT = "dctseg.engine.tiled_probs"
TRAIN_ROOT = "dctseg.trainer.step"


def span_reader(name: str, root: str, span: str):
    """The ``read(ctx)`` of metric ``name``: the summed inclusive duration
    of the host events named ``span`` that start in the stretch
    (``Trace.t0``–``t1``), in ms a volume or step; None, noted as not read,
    unless the stretch holds ``ctx.trace.items`` events named ``root``."""

    def read(ctx):
        t = ctx.trace
        events = [e for e in t.host if t.t0 <= e.time_range.start <= t.t1]
        roots = sum(e.name == root for e in events)
        if roots != t.items:
            ctx.missing(name, f"{roots} {root} spans over {t.items} items")
            return None
        us = sum(e.time_range.elapsed_us() for e in events if e.name == span)
        return us / 1e3 / t.items

    return read
