"""Traffic kind ``train_steps``: the train driver's job, B=1 steps of the
port's ``Trainer`` over a dataset root read from disk.

Set-up writes the dataset once per checkout (``cases`` synthetic cases as
gzipped NIfTI files, a list of ``list_length`` entries cycling over them,
as long as a BraTS training split, so that no epoch ends inside a run),
builds the configuration as the train driver does from its arguments
(``train_driver_args``, where ``{root}`` stands for the dataset root; held
to the file's ``model``, ``train`` and ``data``), and a ``Trainer`` whose
parameters get the seed's weights.  Its own loader and device feeder give
the batches: loader threads crop at random, z-score and make the edge
maps; one batch is copied ahead.  With ``--cache-dir`` the dataset decodes
each case's files once into its preprocessed-volume cache, which set-up
fills once per checkout, case by case, before the loader starts.

The first ``checked_steps`` steps go through ``Trainer.train_step`` as the
window's do, then ``warm_steps`` more; then the window: steps until
``--seconds`` have passed, each step's metrics fetched one step late as
the train driver's loop does, a synchronise at the end.
``train_memory_peak_gb`` is the card's allocation peak of the job up to
the window's end; the window over the steps is the per-layer
``step_ms.train``.  With ``--trace 1`` a stretch of
``stretch`` more steps runs under the profiler.

``correct``: after the window the port's state is freed and the reference
takes the first steps again from the same weights, dropout generator and
files: the loader's batches (``batch_mismatch``: elements that differ,
exact), each step's loss (``loss_gap``: the worst relative gap), the first
gradient as Adam got it, worked out from its first moment after one step
(``grad_gap``: by the worst leaf, the gap of the norms over the larger of
the leaf's and the median leaf's reference norm), and the parameters'
change after the checked steps (``change_gap``: the same, leaving out
leaves whose reference gradient is under a thousandth of the median
leaf's, which move by round-off alone).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import data
from benchmark.harness import free, log, memory_peak, synchronize
from benchmark.reference import adam as refadam
from benchmark.reference import loader as refloader
from benchmark.reference import loss as refloss
from benchmark.reference import model as refmodel
from benchmark.weights import make_weights

BETA1 = 0.9


def dataset_root(ctx) -> str:
    p, d = ctx.params, ctx.config["data"]
    tag = "x".join(map(str, d["input_shape"]))
    return str(ctx.work / f"brats_{p['data_seed']}_{p['cases']}_"
               f"{p['list_length']}_{tag}")


def build_trainer(ctx, root: str, seed: int, weights):
    from dctseg_torch.cli.train import build_config, parse_args
    from dctseg_torch.train.trainer import Trainer
    cfg = build_config(parse_args(
        [a.format(root=root) for a in ctx.config["train_driver_args"]]
        + ["--root", root, "--seed", str(seed)]))
    for section in ("model", "train", "data"):
        got = getattr(cfg, section)
        for key, want in ctx.config[section].items():
            if isinstance(want, str):
                want = want.format(root=root)
            have = getattr(got, key)
            if (list(have) if isinstance(have, tuple) else have) != want:
                raise RuntimeError(f"the train driver builds {section}."
                                   f"{key}={have!r}; the configuration "
                                   f"says {want!r}")
    trainer = Trainer(cfg, device=ctx.device)
    trainer.init_state()
    trainer.model.load_state_dict(weights, strict=True)
    return trainer


def fill_cache(trainer, root: str) -> None:
    """Fill the dataset's preprocessed-volume cache, one case after the
    other, where it keeps one and this checkout has not filled it yet."""
    ds = trainer.dataset
    done = root + ".cache_filled"
    if not ds.cfg.cache_dir or os.path.exists(done):
        return
    first = {}
    for i, name in enumerate(ds.names):
        first.setdefault(name, i)
    for i in first.values():
        ds.get(i, None)
    with open(done, "w") as f:
        f.write(ds.cfg.cache_dir + "\n")


def batches(trainer):
    """The trainer's device batches over its epochs, as its loop takes
    them."""
    epoch = 0
    while True:
        trainer.loader.set_epoch(epoch)
        yield from trainer._device_batches()
        epoch += 1


def start(ctx):
    """Set-up up to the checked steps: (dataset root, the trainer's seed,
    the weights, the trainer, its batch feed, what the checked steps gave:
    their batches, losses, first gradient and change, as norms)."""
    p, dev = ctx.params, ctx.device
    root = dataset_root(ctx)
    data.write_dataset(root, p["data_seed"], p["cases"], p["list_length"],
                       ctx.config["data"]["input_shape"], dev)
    seed = ctx.seed_for("train")
    weights = make_weights(ctx.config["model"], ctx.seed_for("weights"), dev)
    trainer = build_trainer(ctx, root, seed, weights)
    fill_cache(trainer, root)
    feed = batches(trainer)
    params = dict(trainer.model.named_parameters())
    seen, losses, grad = [], [], None
    for i in range(p["checked_steps"]):
        x, t, e = next(feed)
        seen.append((x.clone(), t.clone(), e.clone()))
        losses.append(trainer.train_step(x, t, e)["loss"])
        if i == 0:
            # a step that kept no first moment gave Adam no gradient
            grad = {n: trainer.optimizer.state[q].get(
                "exp_avg", torch.zeros_like(q)) / (1 - BETA1)
                for n, q in params.items()}
    checked = {"seen": seen, "losses": [float(v) for v in losses],
               "grad": {n: g.norm().item() for n, g in grad.items()},
               "change": {n: (q.detach() - weights[n]).norm().item()
                          for n, q in params.items()}}
    return root, seed, weights, trainer, feed, checked


def stop(ctx, trainer, feed) -> int:
    """Stop the feed and free the trainer; its steps per epoch."""
    steps_per_epoch = trainer.steps_per_epoch
    feed.close()
    del trainer
    free(ctx.device)
    return steps_per_epoch


def calibrate(ctx) -> dict:
    """The compared numbers of the checked steps for the program and for
    the control (the reference in float8 in the program's place), each
    against the float32 reference."""
    root, seed, weights, trainer, feed, checked = start(ctx)
    spe = stop(ctx, trainer, feed)
    ref_batches = reference_batches(ctx, root, seed, len(checked["seen"]))
    ref = reference_steps(ctx, seed, weights, ref_batches, spe)
    control = reference_steps(ctx, seed, weights, ref_batches, spe, "fp8")
    frozen = reference_steps(ctx, seed, weights, ref_batches, spe,
                             frozen=True)
    return {"program": {"batch_mismatch": batch_mismatch(checked["seen"],
                                                         ref_batches),
                        **compare(checked, ref)},
            "control": compare(control, ref),
            "fault_unchanged": compare(frozen, ref),
            "worst": {"program": worst_leaves(checked, ref),
                      "control": worst_leaves(control, ref)}}


def run(ctx) -> None:
    p, dev = ctx.params, ctx.device
    root, seed, weights, trainer, feed, checked = start(ctx)
    pending = None
    for _ in range(p["warm_steps"]):
        x, t, e = next(feed)
        pending = trainer.train_step(x, t, e)
    {k: v.tolist() for k, v in pending.items()}
    synchronize(dev)
    ctx.setup_done()

    steps, t0, pending = 0, time.perf_counter(), None
    while True:
        with ctx.spans.span("loader_wait"):
            x, t, e = next(feed)
        with ctx.spans.span("step"):
            metrics = trainer.train_step(x, t, e)
        if pending is not None:
            {k: v.tolist() for k, v in pending.items()}
        pending = metrics
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    {k: v.tolist() for k, v in pending.items()}
    synchronize(dev)
    window = time.perf_counter() - t0
    ctx.memory_peak = memory_peak(dev)
    ctx.attempted = steps
    ctx.window = {"seconds": window, "items": steps, "t0": t0,
                  "t1": t0 + window}
    ctx.metrics["train_memory_peak_gb"] = ctx.memory_peak / 1e9
    gaps = np.diff([a for n, a, _ in ctx.spans.records
                    if n == "loader_wait"]) * 1e3
    log(f"steps {steps} in {window:.6f} s" + (
        f"; between steps (ms) median {np.median(gaps):.4f}, quartiles "
        f"{np.quantile(gaps, 0.25):.4f} {np.quantile(gaps, 0.75):.4f}, "
        f"max {gaps.max():.4f}" if gaps.size else ""))

    if ctx.trace_on:
        n, pending = p["stretch"], None
        with ctx.stretch(n):
            for _ in range(n):
                with ctx.spans.span("loader_wait"):
                    x, t, e = next(feed)
                with ctx.spans.span("step"):
                    metrics = trainer.train_step(x, t, e)
                if pending is not None:
                    {k: v.tolist() for k, v in pending.items()}
                pending = metrics
            {k: v.tolist() for k, v in pending.items()}

    del x, t, e, metrics, pending
    spe = stop(ctx, trainer, feed)
    ref_batches = reference_batches(ctx, root, seed, len(checked["seen"]))
    found = {"batch_mismatch": batch_mismatch(checked["seen"], ref_batches)}
    found.update(compare(checked, reference_steps(ctx, seed, weights,
                                                  ref_batches, spe)))
    limits = ctx.cell["limits"]
    for name in limits:
        ctx.check(name, found.get(name, float("nan")), limits[name])
    for name, value in found.items():
        if name not in limits:
            ctx.notes.append(f"{name} {value!r} (not compared)")


def relative_gaps(port: dict, ref: dict, names, over=max) -> float:
    """``over`` (the worst, or the median) leaf of ``names`` of
    |port - ref| / max(ref, the median of ref over ``names``)."""
    names = list(names)
    med = float(np.median([ref[n] for n in names]))
    return float(over([abs(port[n] - ref[n]) / max(ref[n], med, 1e-30)
                       for n in names]))


def reference_batches(ctx, root, seed, count):
    """The loader's first ``count`` batches, worked out from the files."""
    d = ctx.config["data"]
    stats32 = bool(d.get("cache_dir"))
    with open(os.path.join(root, "train.txt")) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    order = refloader.epoch_order(len(names), seed, 0)
    cases, out = {}, []
    for i in range(count):
        idx = int(order[i])
        name = names[idx]
        if name not in cases:
            cases[name] = refloader.load_case(root, name, data.MODALITIES)
        x, t, e = refloader.train_item(*cases[name], tuple(d["crop_size"]),
                                       d["pad_depth"], seed, 0, idx,
                                       stats32)
        out.append((torch.from_numpy(x).to(ctx.device).to(
            getattr(torch, d["transfer_dtype"]))[None],
            torch.from_numpy(t).to(ctx.device)[None],
            torch.from_numpy(e).to(ctx.device)[None]))
    return out


def reference_steps(ctx, seed, weights, batches, steps_per_epoch,
                    precision: str = "float32", frozen: bool = False) -> dict:
    """The reference's checked steps from ``weights`` on ``batches``, in
    ``precision``: each step's loss, per leaf the first gradient as Adam
    gets it and the raw one, and the change after the last step (norms).
    ``frozen``: the fault of a step that leaves its state unchanged (Adam
    gets nothing, nothing moves)."""
    tc = ctx.config["train"]
    refmodel.strict_float32()
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()
              if not n.endswith(".pe")}
    tables = {n: w for n, w in weights.items() if n.endswith(".pe")}
    net = refmodel.ClsWiseFormerRef(ctx.config["model"],
                                    {**params, **tables}, precision)
    opt = refadam.Adam(tc["weight_decay"])
    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    losses, raw = [], {}
    for step, (x, t, e) in enumerate(batches):
        loss = refloss.total_loss(net.forward(x.float(), gen), t, e)
        loss.backward()
        if step == 0:
            raw = {n: q.grad.norm().item() for n, q in params.items()}
        losses.append(loss.item())
        if frozen:
            for q in params.values():
                q.grad = None
            continue
        opt.step(params, refadam.poly_lr(tc["lr"], tc["end_epoch"],
                                         steps_per_epoch, tc["poly_power"],
                                         step))
    return {"losses": losses, "raw": raw,
            "grad": {n: (opt.first_grad[n].norm().item()
                         if n in opt.first_grad else 0.0) for n in params},
            "change": {n: (q.detach() - weights[n]).norm().item()
                       for n, q in params.items()}}


def moving_leaves(ref: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's (a conv bias under
    InstanceNorm has none, and moves under Adam by round-off alone)."""
    med = float(np.median(list(ref["raw"].values())))
    return [n for n in ref["raw"] if ref["raw"][n] >= 1e-3 * med]


def compare(got: dict, ref: dict) -> dict:
    """loss_gap, grad_gap and change_gap of ``got`` against ``ref`` (both
    as :func:`reference_steps` gives them), over the moving leaves."""
    moving = moving_leaves(ref)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], ref["losses"])),
            "grad_gap": relative_gaps(got["grad"], ref["grad"], moving),
            "grad_gap_median": relative_gaps(got["grad"], ref["grad"],
                                             moving, np.median),
            "change_gap": relative_gaps(got["change"], ref["change"],
                                        moving)}


def worst_leaves(got: dict, ref: dict) -> dict:
    """For each gap, the leaf that sets it, and the median leaf's gap."""
    moving = moving_leaves(ref)
    out = {}
    for key in ("grad", "change"):
        med = float(np.median([ref[key][n] for n in moving]))
        gaps = {n: abs(got[key][n] - ref[key][n]) / max(ref[key][n], med,
                                                        1e-30)
                for n in moving}
        worst = max(gaps, key=gaps.get)
        out[key] = [worst, gaps[worst], float(np.median(list(
            gaps.values())))]
    return out


def batch_mismatch(seen, ref_batches) -> int:
    """Elements of the loader's batches that differ from the reference's."""
    return sum(int((a != b).sum()) for got, want in zip(seen, ref_batches)
               for a, b in zip(got, want))
