"""Traffic kind ``serve_regions``: one closed-loop caller sends whole
volumes back to back to the port's engine running a region-head model
(Swin UNETR: sigmoids of TC, WT and ET), as a service or an archive scorer
does.

Set-up builds the configuration's model (``dctseg_torch.models.swin_unetr``
``build_model`` from the ``model`` section) with the seed's weights, the
engine (``Predictor``, the configuration's ``engine`` options) and a pool
of ``pool`` distinct z-scored volumes in ordinary host memory, and warms up
on ``warmup`` of them.  A request hands one volume to
``Predictor.tiled_probs`` and ends when its uint8 labels (BRATS21's region
rule, the port's ``region_labels``) are on the host.  The order of the
pool's volumes is a run of seeded permutations.

The window runs requests until ``--seconds`` have passed and the last one
has finished: ``volumes_per_s`` is the requests over the window,
``volume_p95_ms`` the 95th percentile of all its requests' latencies.  With
``--trace 1`` a stretch of ``stretch`` more requests runs under the
profiler, and the port's launch counters' moves over it are kept on
``ctx.program_launches`` (by function name) for the readers.

``correct``: after the window the port's state is freed and the reference
(``reference/swin_unetr.py``, float32) works out each pool volume's
probabilities (its own crops, the forward in blocks of ``reference_block``
crops, the stitch of ``serve_volumes``).  Every request's labels are held
to them: each served label implies, by the region rule, a decision on some
channels (3: ET on; 1: ET off, TC on; 2: ET and TC off, WT on; 0: all
off), and ``label_gap`` is the largest distance by which the reference's
probability lies on the wrong side of 0.5 for such a decision, over every
voxel of every request.  The first request of ``sampled`` pool volumes
keeps its probabilities on the card through the window: ``prob_gap_q90``
is the 90th percentile over their voxels of the largest channel gap to the
reference's.  The numbers the cell gives a limit are compared; the others
are printed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import data
from benchmark.harness import free, log, memory_peak, synchronize
from benchmark.reference import swin_unetr as refmodel
from benchmark.traffic.serve_volumes import CROPS, prob_stats, stitch


def reference_probs(ref, vol: torch.Tensor, block: int) -> torch.Tensor:
    """The reference's (240, 240, 155, 3) probabilities of one volume."""
    crops = torch.cat([vol[:, h0:h1, w0:w1, d0:d1]
                       for (h0, h1), (w0, w1), (d0, d1) in CROPS])
    with torch.no_grad():
        out = torch.cat([ref.forward(crops[i:i + block])[0]
                         for i in range(0, len(crops), block)])
    return stitch(out)


def decision_gap(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per voxel, the largest distance by which ``probs`` (.., 3: TC, WT,
    ET) lies on the wrong side of 0.5 for a decision the region rule takes
    to give ``labels``."""
    tc, wt, et = probs.unbind(-1)
    lab = labels.long()

    def on(p):          # the rule needs p > 0.5
        return (0.5 - p).clamp(min=0.0)

    def off(p):         # the rule needs p <= 0.5
        return (p - 0.5).clamp(min=0.0)
    gap = torch.maximum(off(et), torch.maximum(off(tc), off(wt)))    # 0
    gap = torch.where(lab == 2, torch.maximum(
        torch.maximum(off(et), off(tc)), on(wt)), gap)
    gap = torch.where(lab == 1, torch.maximum(off(et), on(tc)), gap)
    return torch.where(lab == 3, on(et), gap)


def rule_labels(probs: torch.Tensor) -> torch.Tensor:
    """BRATS21 ``test.py``'s labels of (.., 3) probabilities, worked out
    here again: WT -> 2, then TC -> 1, then ET -> 3 (BraTS 4)."""
    on = probs > 0.5
    out = torch.zeros(probs.shape[:-1], dtype=torch.long,
                      device=probs.device)
    out[on[..., 1]] = 2
    out[on[..., 0]] = 1
    out[on[..., 2]] = 3
    return out


def gap_stats(probs: torch.Tensor, labels: torch.Tensor) -> dict:
    """label_gap, and the share of voxels whose served label is not the
    reference's by the rule."""
    return {"label_gap": float(decision_gap(probs, labels).max()),
            "disagree": float((labels.long() != rule_labels(probs)).float()
                              .mean())}


def build_engine(ctx, weights, **overrides):
    from dctseg_torch.infer.engine import Predictor
    from dctseg_torch.models import swin_unetr
    cfg = swin_unetr.SwinUNETRConfig.from_dict({**ctx.config["model"],
                                                **overrides})
    model = swin_unetr.build_model(cfg, device=ctx.device)
    model.load_state_dict(weights, strict=True)
    return Predictor(model, device=ctx.device, **ctx.config["engine"])


def labels_of(probs: torch.Tensor) -> torch.Tensor:
    """The port's labels of the engine's (1, .., 3) probabilities, on the
    host."""
    from dctseg_torch.models.swin_unetr import region_labels
    return region_labels(probs[0]).cpu()


def run(ctx) -> None:
    from dctseg_torch.ops import _build
    p, dev = ctx.params, ctx.device
    weights = refmodel.make_weights(ctx.config["model"],
                                    ctx.seed_for("weights"), dev)
    predictor = build_engine(ctx, weights)
    pool = data.serve_volumes(ctx.seed_for("volumes"), p["pool"],
                              tuple(p["volume"]), dev)
    rng = np.random.default_rng(ctx.seed_for("order"))
    order = iter(np.concatenate([rng.permutation(p["pool"])
                                 for _ in range(p["max_requests"]
                                                // p["pool"])]))
    for i in range(p["warmup"]):
        labels_of(predictor.tiled_probs(pool[i]))
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
        labels = labels_of(probs)
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
        before = _build.launch_counts()
        with ctx.stretch(n):
            for _ in range(n):
                v = int(next(order))
                with ctx.spans.span("request"):
                    served.append((v, labels_of(
                        predictor.tiled_probs(pool[v]))))
        moved: dict = {}
        for (fn, attr, kind), k in _build.launches_since(before).items():
            if kind is None:
                moved[fn.__name__] = moved.get(fn.__name__, 0) + k
        ctx.program_launches = moved

    del predictor
    free(dev)
    check(ctx, weights, pool, served, kept)


def check(ctx, weights, pool, served, kept) -> None:
    """Hold the sampled requests' probabilities, and every request's
    labels, to the reference's probabilities of their volumes.  The numbers
    the cell gives a limit are compared; the others are noted."""
    refmodel.strict_float32()
    ref = refmodel.SwinUNETRRef(ctx.config["model"], weights)
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
    float32 reference: of the program, and of the control, the reference
    in float8 in the program's place.  Each number is the largest over the
    volumes."""
    p, dev = ctx.params, ctx.device
    weights = refmodel.make_weights(ctx.config["model"],
                                    ctx.seed_for("weights"), dev)
    pool = data.serve_volumes(ctx.seed_for("volumes"), p["pool"],
                              tuple(p["volume"]), dev)
    predictor = build_engine(ctx, weights)
    predictor.tiled_probs(pool[0])
    served = [predictor.tiled_probs(pool[v]) for v in range(p["pool"])]
    del predictor
    free(dev)
    refmodel.strict_float32()
    ref = refmodel.SwinUNETRRef(ctx.config["model"], weights)
    fp8 = refmodel.SwinUNETRRef(ctx.config["model"], weights, "fp8")
    out = {k: {} for k in ("program", "control")}
    for v in range(p["pool"]):
        vol = pool[v].to(dev)
        probs = reference_probs(ref, vol, p["reference_block"])
        got = {"program": served[v],
               "control": reference_probs(fp8, vol, p["reference_block"])}
        for kind, g in got.items():
            g = g.reshape(probs.shape)
            st = {**prob_stats(g, probs),
                  **gap_stats(probs, rule_labels(g))}
            for k, x in st.items():
                out[kind][k] = max(out[kind].get(k, 0.0), x)
        del probs, got
    return out
