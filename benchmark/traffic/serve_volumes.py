"""Traffic kind ``serve_volumes``: one closed-loop caller sends whole
volumes back to back to the port's engine, as a service or an archive
scorer does.

Set-up builds the configuration's model with the seed's weights, the
engine (``Predictor``) and a pool of ``pool`` distinct z-scored volumes in
ordinary host memory, and warms up on ``warmup`` of them.  A request hands
one volume to ``Predictor.tiled_probs`` (the engine built with the
configuration's ``engine`` options) and ends when its uint8 argmax labels
are on the host.  The order
of the pool's volumes is a run of seeded permutations.

The window runs requests until ``--seconds`` have passed and the last one
has finished: ``volumes_per_s`` is the requests over the window,
``volume_p95_ms`` the 95th percentile of all its requests' latencies.  With
``--trace 1`` a stretch of ``stretch`` more requests runs under the
profiler.

``correct``: after the window the port's state is freed and the reference
works out each pool volume's probabilities (its own crops, the float32
forward in blocks of ``reference_block`` crops, its own stitch).  Every
request's labels are held to them: ``label_gap`` is the largest amount by
which the reference's probability of a served label lies below its most
probable class, over every voxel of every request.  The first request of
``sampled`` pool volumes drawn from the seed keeps its probabilities on the
card through the window: ``prob_gap_q90`` is the 90th percentile over
their voxels of the largest class gap to the reference's.  The numbers the
cell gives a limit are compared; the others are printed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import data
from benchmark.harness import free, log, memory_peak, synchronize
from benchmark.reference import model as refmodel
from benchmark.weights import make_weights

# (H, W, D) windows of the engine's eight 128^3 crops of a 240x240x160
# volume, and where the stitch takes each crop's output
CROPS = [((0, 128), (0, 128), (0, 128)), ((0, 128), (112, 240), (0, 128)),
         ((112, 240), (0, 128), (0, 128)),
         ((112, 240), (112, 240), (0, 128)),
         ((0, 128), (0, 128), (27, 155)), ((0, 128), (112, 240), (27, 155)),
         ((112, 240), (0, 128), (27, 155)),
         ((112, 240), (112, 240), (27, 155))]


def stitch(t: torch.Tensor) -> torch.Tensor:
    """(8, 128, 128, 128, C) crop outputs -> (240, 240, 155, C); later
    crops overwrite the 16-voxel overlaps with their inner part; the deep
    crops' slices 96:123 land on 128:155 (the published stitch)."""
    y = t.new_zeros((240, 240, 155, t.shape[-1]))
    y[:128, :128, :128] = t[0]
    y[:128, 128:, :128] = t[1, :, 16:]
    y[128:, :128, :128] = t[2, 16:]
    y[128:, 128:, :128] = t[3, 16:, 16:]
    y[:128, :128, 128:] = t[4, :, :, 96:123]
    y[:128, 128:, 128:] = t[5, :, 16:, 96:123]
    y[128:, :128, 128:] = t[6, 16:, :, 96:123]
    y[128:, 128:, 128:] = t[7, 16:, 16:, 96:123]
    return y


def reference_probs(ref, vol: torch.Tensor, block: int) -> torch.Tensor:
    """The reference's (240, 240, 155, C) probabilities of one volume."""
    crops = torch.cat([vol[:, h0:h1, w0:w1, d0:d1]
                       for (h0, h1), (w0, w1), (d0, d1) in CROPS])
    with torch.no_grad():
        out = torch.cat([ref.forward(crops[i:i + block])[0]
                         for i in range(0, len(crops), block)])
    return stitch(out)


PROB_QUANTILES = {"prob_gap_q50": 0.5, "prob_gap_q90": 0.9,
                  "prob_gap_q99": 0.99}


def prob_stats(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Quantiles over the voxels, and the mean, of the largest gap between
    two (.., C) probability maps over the classes."""
    d = (got.reshape(want.shape).float() - want).abs().amax(-1).flatten()
    out = {k: float(d.kthvalue(max(1, int(q * d.numel()))).values)
           for k, q in PROB_QUANTILES.items()}
    out["prob_gap_mean"] = float(d.mean())
    return out


def gap_stats(probs: torch.Tensor, labels: torch.Tensor) -> dict:
    """label_gap, and the share of voxels whose served label is not the
    reference's most probable class."""
    served = probs.gather(-1, labels.long()[..., None])[..., 0]
    gap = probs.max(dim=-1).values - served
    return {"label_gap": float(gap.max()),
            "disagree": float((labels.long() != probs.argmax(-1)).float()
                              .mean())}


def build_engine(ctx, weights, **overrides):
    from dctseg_torch.config import ModelConfig
    from dctseg_torch.infer.engine import Predictor
    from dctseg_torch.models.clswiseformer import build_model
    model = build_model(ModelConfig(**{**ctx.config["model"], **overrides}),
                        device=ctx.device)
    model.load_state_dict(weights, strict=True)
    return Predictor(model, device=ctx.device, **ctx.config["engine"])


def request(predictor, vol):
    """One request: the engine's probabilities of ``vol``, labels on the
    host."""
    probs = predictor.tiled_probs(vol)
    return probs[0].argmax(dim=-1).to(torch.uint8).cpu()


def run(ctx) -> None:
    p, dev = ctx.params, ctx.device
    weights = make_weights(ctx.config["model"], ctx.seed_for("weights"), dev)
    predictor = build_engine(ctx, weights)
    pool = data.serve_volumes(ctx.seed_for("volumes"), p["pool"],
                              tuple(p["volume"]), dev)
    rng = np.random.default_rng(ctx.seed_for("order"))
    order = iter(np.concatenate([rng.permutation(p["pool"])
                                 for _ in range(p["max_requests"]
                                                // p["pool"])]))
    for i in range(p["warmup"]):
        request(predictor, pool[i])
    synchronize(dev)
    ctx.setup_done()

    # the volumes whose first request keeps its probabilities on the card
    sample = set(rng.choice(p["pool"], p["sampled"], replace=False).tolist())
    served, latencies, kept = [], [], {}
    t0 = time.perf_counter()
    while True:
        v = int(next(order))
        ts = time.perf_counter()
        with ctx.spans.span("engine"):
            probs = predictor.tiled_probs(pool[v])
        labels = probs[0].argmax(dim=-1).to(torch.uint8).cpu()
        te = time.perf_counter()
        if v in sample and v not in kept:
            kept[v] = probs
        del probs
        latencies.append(te - ts)
        served.append((v, labels))
        if te - t0 >= ctx.seconds:
            break
    window = te - t0
    ctx.memory_peak = memory_peak(dev)
    ctx.attempted = len(served)
    ctx.window = {"seconds": window, "items": len(served), "t0": t0,
                  "t1": te}
    ctx.metrics["volumes_per_s"] = len(served) / window
    ctx.metrics["volume_p95_ms"] = float(
        np.quantile(np.asarray(latencies), 0.95)) * 1e3
    log(f"requests {len(served)} in {window:.6f} s; latency median "
        f"{np.median(latencies) * 1e3:.4f} ms, p95 "
        f"{ctx.metrics['volume_p95_ms']:.4f} ms")

    if ctx.trace_on:
        n = p["stretch"]
        with ctx.stretch(n):
            for _ in range(n):
                v = int(next(order))
                with ctx.spans.span("request"):
                    served.append((v, request(predictor, pool[v])))

    del predictor
    free(dev)
    check(ctx, weights, pool, served, kept)


def check(ctx, weights, pool, served, kept) -> None:
    """Hold the sampled requests' probabilities, and every request's
    labels, to the reference's probabilities of their volumes.  The numbers
    the cell gives a limit are compared; the others are noted."""
    refmodel.strict_float32()
    ref = refmodel.ClsWiseFormerRef(ctx.config["model"], weights)
    found = {}
    for v in sorted({v for v, _ in served}):
        probs = reference_probs(ref, pool[v].to(ctx.device),
                                ctx.params["reference_block"])
        stats = [gap_stats(probs, labels.to(ctx.device))
                 for u, labels in served if u == v]
        if v in kept:
            stats.append(prob_stats(kept[v], probs))
        for st in stats:
            for k, x in st.items():
                found[k] = max(found.get(k, 0.0), x)
        del probs
    limits = ctx.cell["limits"]
    for name in limits:
        ctx.check(name, found.get(name, float("nan")), limits[name])
    for name, value in found.items():
        if name not in limits:
            ctx.notes.append(f"{name} {value!r} (not compared)")


def calibrate(ctx) -> dict:
    """Readings on this seed's pool, one request a volume, each against the
    float32 reference: of the program; of the control, the reference in
    float8 in the program's place; and of the program's own int8 path
    (``quantize='int8'``), which runs only the convs of 64 or more input
    channels in int8.  Each number is the largest over the volumes."""
    p, dev = ctx.params, ctx.device
    weights = make_weights(ctx.config["model"], ctx.seed_for("weights"), dev)
    pool = data.serve_volumes(ctx.seed_for("volumes"), p["pool"],
                              tuple(p["volume"]), dev)
    served = {}
    for kind, overrides in (("program", {}), ("int8", {"quantize":
                                                       "int8"})):
        predictor = build_engine(ctx, weights, **overrides)
        request(predictor, pool[0])
        served[kind] = [predictor.tiled_probs(pool[v])
                        for v in range(p["pool"])]
        del predictor
        free(dev)
    refmodel.strict_float32()
    ref = refmodel.ClsWiseFormerRef(ctx.config["model"], weights)
    fp8 = refmodel.ClsWiseFormerRef(ctx.config["model"], weights, "fp8")
    out = {k: {} for k in ("program", "control", "int8")}
    for v in range(p["pool"]):
        vol = pool[v].to(dev)
        probs = reference_probs(ref, vol, p["reference_block"])
        got = {"program": served["program"][v], "int8": served["int8"][v],
               "control": reference_probs(fp8, vol, p["reference_block"])}
        for kind, g in got.items():
            g = g.reshape(probs.shape)
            st = {**prob_stats(g, probs), **gap_stats(probs, g.argmax(-1))}
            for k, x in st.items():
                out[kind][k] = max(out[kind].get(k, 0.0), x)
        del probs, got
    return out
