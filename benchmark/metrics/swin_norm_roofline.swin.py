"""swin_norm_roofline.swin: the byte bound of a volume's Swin encoder
LayerNorms over K9's device time a volume in the profiled stretch.

The bound, from the configuration's widths (8 crops of 128^3, patch 2):
every input row read once and every output row written once, at HBM's
rate.  A block's norm1 reads its T token rows and writes the P rows of its
windows over the grid padded to the window (the padding rows included);
its norm2 reads T window rows and the T rows of x, and writes the sum and
the norm (4 T); each stage's merging norm reads and writes its gathered
rows; each of the five ``proj_out`` norms reads and writes its rows.  At
the published widths 4.49 GB, 1.34 ms.

Read only where the profile holds as many K9 kernels
(``layer_norm_kernel``) as K9's counters moved over the stretch
(``ctx.program_launches``, kept by the traffic kind), as
``window_attn_roofline.swin`` does."""

from benchmark.reference.counts import HBM_BYTES_PER_S

NAME = "swin_norm_roofline.swin"
KERNEL = r"dctseg::.*\blayer_norm_kernel\b"
COUNTERS = ("layer_norm_to_windows", "windows_residual_layer_norm",
            "layer_norm")
CROP, PATCH, BATCH = 128, 2, 8


def norm_bytes(model: dict, batch: int = BATCH, img: int = CROP) -> int:
    """The bound's bytes of one forward of ``batch`` crops of ``img``^3."""
    elem = 2 if model["compute_dtype"] in ("bfloat16", "float16") else 4
    ws, fs = model["window_size"], model["feature_size"]
    edge, elems = img // PATCH, 0
    proj = edge ** 3 * fs              # proj_out of the patch embedding
    for i, depth in enumerate(model["depths"]):
        c = fs << i
        tokens = edge ** 3 * c
        win = edge if edge <= ws else ws
        pad = -(-edge // win) * win
        elems += depth * (tokens + pad ** 3 * c + 4 * tokens)
        edge = -(-edge // 2)
        merged = edge ** 3 * 8 * c
        elems += 2 * merged
        proj += edge ** 3 * 2 * c      # proj_out of the stage's output
    return (elems + 2 * proj) * elem * batch


def read(ctx):
    t = ctx.trace
    launches = getattr(ctx, "program_launches", {})
    launched = sum(launches.get(n, 0) for n in COUNTERS)
    if not launched:
        ctx.missing(NAME, "the stretch launched no K9 kernel")
        return None
    times = t.kernels(KERNEL)
    if len(times) != launched:
        ctx.missing(NAME, f"the profile holds {len(times)} of the "
                    f"{launched} K9 launches")
        return None
    bound_s = norm_bytes(ctx.config["model"]) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (sum(times) / t.items)
