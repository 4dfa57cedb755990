"""swin_vit_ms.swin: device time a volume of the Swin encoder (patch
embedding, the four stages of shifted-window blocks and merging, the
outputs' LayerNorms): the kernels under the program's span
``dctseg.swin.vit`` in the profiled stretch.  Read only where the stretch
holds one such span a volume, each with device time."""

NAME = "swin_vit_ms.swin"
SPAN = "dctseg.swin.vit"


def read(ctx):
    t = ctx.trace
    seconds, calls, empty = t.op_device_s([SPAN])
    if calls != t.items or empty:
        ctx.missing(NAME, f"{calls} {SPAN} spans, {empty} without device "
                    f"time, over {t.items} volumes")
        return None
    return seconds / t.items * 1e3
