"""The readers of the program's spans (``benchmark/metrics/engine_*_ms.serve``,
``batch_wait_ms.train``, ``step_*_ms.train``): on a synthetic trace, each
returns its span's summed time over the stretch's items and notes "not
read" where the roots are not one an item; on a real CPU profile of the
engine and the Trainer, each reads.  On a card: K1's launch counters count
the fused engine's CUDA-graph replays, as many as the profile's
``norm_kernel`` launches (``python -m pytest benchmark/tests -m card -q``).
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness

SEED = 2 ** 31 + 2024
ROOTS = {"serve": "dctseg.engine.tiled_probs", "train": "dctseg.trainer.step"}
READERS = {
    "engine_input_ms.serve": "dctseg.engine.input",
    "engine_forward_ms.serve": "dctseg.engine.forward",
    "engine_stitch_ms.serve": "dctseg.engine.stitch",
    "batch_wait_ms.train": "dctseg.trainer.batch_wait",
    "step_forward_ms.train": "dctseg.trainer.forward",
    "step_backward_ms.train": "dctseg.trainer.backward",
    "step_optimizer_ms.train": "dctseg.trainer.optimizer",
}


def event(name, start, end):
    """A host event as ``Trace.host`` holds them (times in us)."""
    rng = SimpleNamespace(start=start, end=end,
                          elapsed_us=lambda: end - start)
    return SimpleNamespace(name=name, time_range=rng)


def fake_ctx(events, items, t0=1000.0, t1=9000.0):
    ctx = SimpleNamespace(notes=[], trace=SimpleNamespace(
        host=events, items=items, t0=t0, t1=t1))
    ctx.missing = lambda metric, reason: ctx.notes.append(
        f"{metric}: not read: {reason}")
    return ctx


def synthetic(metric, roots):
    """``roots`` items of 2000 us, each with two intervals of the metric's
    span (300 and 200 us) and one of another span; one more interval of
    the span starting before the stretch."""
    span, root = READERS[metric], ROOTS[metric.rsplit(".", 1)[1]]
    other = "dctseg.engine.other"
    events = [event(span, 500.0, 1500.0), event("aten::add", 1100, 1200)]
    for i in range(roots):
        a = 1000.0 + 2500 * i
        events += [event(root, a, a + 2000), event(span, a + 100, a + 400),
                   event(other, a + 400, a + 900),
                   event(span, a + 1000, a + 1200)]
    return events


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_returns_the_span_time_an_item(metric):
    ctx = fake_ctx(synthetic(metric, 3), items=3)
    assert harness.reader(metric)(ctx) == pytest.approx(0.5)
    assert ctx.notes == []


@pytest.mark.parametrize("metric", sorted(READERS))
@pytest.mark.parametrize("roots", [0, 2, 4])
def test_reader_notes_roots_that_are_not_one_an_item(metric, roots):
    ctx = fake_ctx(synthetic(metric, roots), items=3)
    assert harness.reader(metric)(ctx) is None
    assert len(ctx.notes) == 1 and ctx.notes[0].startswith(
        f"{metric}: not read: {roots} ")


class _StandIn(torch.nn.Module):
    def forward(self, x):
        return (x * 2.0 + 1.0,)


def cpu_ctx(cell):
    return harness.Ctx(cell, SEED, 0.0, True, time.perf_counter(),
                       device="cpu")


def reads(ctx):
    """The readers of the cell's kind, each of which has to read."""
    kind = ctx.name.split("_")[0]
    got = {m: harness.reader(m)(ctx) for m in READERS
           if m.endswith("." + kind)}
    assert ctx.notes == [] and all(v > 0 for v in got.values()), (
        got, ctx.notes)
    return got


def root_ms(ctx, root):
    t = ctx.trace
    return sum(e.time_range.elapsed_us() for e in t.host
               if e.name == root) / 1e3 / t.items


def test_engine_readers_on_a_cpu_profile():
    from dctseg_torch.infer.engine import Predictor
    predictor = Predictor(_StandIn(), device="cpu")
    vol = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 240, 240, 160, 2)).astype(np.float32))
    ctx = cpu_ctx("serve_bf16_staged")
    with ctx.stretch(2):
        for _ in range(2):
            with ctx.spans.span("request"):
                predictor.tiled_probs(vol)[0].argmax(-1)
    got = reads(ctx)
    assert sum(got.values()) <= root_ms(ctx, ROOTS["serve"])


def test_trainer_readers_on_a_cpu_profile(tmp_path):
    from dctseg_torch.config import (Config, DataConfig, TrainConfig,
                                     tiny_model_config)
    from dctseg_torch.train.trainer import Trainer
    cfg = Config(
        model=tiny_model_config(img_dim=16, top_num=2, fused_norms=False),
        data=DataConfig(synthetic_num_samples=4, input_shape=(24, 24, 20),
                        pad_depth=20, crop_size=(16, 16, 16), num_workers=2),
        train=TrainConfig(end_epoch=1, checkpoint_dir=str(tmp_path)))
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    feed = trainer._device_batches()
    trainer.train_step(*next(feed))
    ctx = cpu_ctx("train_bf16_b1")
    with ctx.stretch(2):
        for _ in range(2):
            with ctx.spans.span("loader_wait"):
                batch = next(feed)
            with ctx.spans.span("step"):
                trainer.train_step(*batch)
    feed.close()
    got = reads(ctx)
    phases = sum(v for k, v in got.items() if k != "batch_wait_ms.train")
    assert phases <= root_ms(ctx, ROOTS["train"])


@pytest.mark.card
def test_fused_replays_count_their_k1_launches(cuda):
    """N replays of the fused engine's captured tiled_probs raise K1's
    counters by N times the capture's launches, and a profiled stretch of
    replays holds as many ``norm_kernel`` launches as the counters moved:
    the guard ``k1_roofline.serve`` reads under."""
    from benchmark.trace import COUNTERS
    from dctseg_torch.config import ModelConfig
    from dctseg_torch.infer.engine import Predictor
    from dctseg_torch.models.clswiseformer import build_model
    from dctseg_torch.ops import fusednorm
    model = build_model(ModelConfig(**harness.config(
        "clswiseformer_serve")["model"]), device=cuda)
    predictor = Predictor(model, device=cuda, fuse_dispatch=True)
    g = torch.Generator(device=cuda).manual_seed(0)
    vols = [torch.randn((1, 240, 240, 160, 4), device=cuda, generator=g)
            for _ in range(3)]
    predictor.tiled_probs(vols[0])
    (captured,) = predictor._graphs.values()
    norms = COUNTERS["fusednorm"][0][1]
    per_replay = sum(n for (fn, attr, _), n in captured.launches.items()
                     if attr == "launches" and fn.__name__ in norms)
    assert per_replay > 0
    before = sum(getattr(fusednorm, op).launches for op in norms)
    for v in vols:
        predictor.tiled_probs(v)
    torch.cuda.synchronize()
    assert sum(getattr(fusednorm, op).launches
               for op in norms) - before == len(vols) * per_replay
    attempts = []
    for _ in range(3):     # the profiler has been seen to drop an event
        ctx = harness.Ctx("serve_bf16_staged", SEED, 0.0, True,
                          time.perf_counter(), device=cuda)
        with ctx.stretch(len(vols)):
            for v in vols:
                predictor.tiled_probs(v)
        kernels = len(ctx.trace.kernels(COUNTERS["fusednorm"][1]))
        attempts.append((ctx.trace.launches["fusednorm"], kernels))
        if attempts[-1] == (len(vols) * per_replay,) * 2:
            break
    assert attempts[-1] == (len(vols) * per_replay,) * 2, attempts
