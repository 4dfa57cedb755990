"""The port's spans (``utils/profiling.py`` ``span``) in the engine and the
Trainer, and the launch counters' bookkeeping of CUDA-graph replays, on the
CPU.

Under ``torch.profiler`` every ``tiled_probs`` call and train step is one
root span with its phases as children, in order; with no profiler running
no span enters a ``record_function``.  A captured stage's replays add the
launches its capture counted (a stub graph stands in for the card's).
"""

import contextlib
import importlib
import inspect
import json
import os
import pkgutil

import numpy as np
import pytest
import torch

import dctseg_torch.ops
from dctseg_torch.config import Config, DataConfig, TrainConfig
from dctseg_torch.config import tiny_model_config
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.models.clswiseformer import build_model
from dctseg_torch.ops import _build, attention, fusednorm
from dctseg_torch.train.optim import make_optimizer
from dctseg_torch.train.trainer import Trainer, train_step
from dctseg_torch.utils import profiling

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

ACTS = [torch.profiler.ProfilerActivity.CPU]


class _StandIn(torch.nn.Module):
    """A pass-through model: tiled_probs needs 128^3 crops."""

    def forward(self, x):
        return (x * 2.0 + 1.0,)


@pytest.fixture(scope="module")
def volume():
    return np.random.default_rng(2).normal(
        size=(1, 240, 240, 160, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_model_config(fused_norms=True, s2d_fullres=False,
                            s2d_halfres=False)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 32, 32, 32, 4)).astype(np.float32))
    return model, x


def spans(prof):
    """The profile's spans, in start order."""
    return sorted((e for e in prof.events()
                   if e.name.startswith(profiling.SPAN_PREFIX)),
                  key=lambda e: e.time_range.start)


def tree(prof):
    """[(root name, [child names in order])] of the profile's spans: a
    child is the nearest span above it."""
    out, found = [], spans(prof)

    def span_parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith(profiling.SPAN_PREFIX):
            p = p.cpu_parent
        return p

    for e in found:
        if span_parent(e) is None:
            out.append((e.name, [c.name for c in found
                                 if span_parent(c) is e]))
    return out


def profiled(fn):
    with torch.profiler.profile(activities=ACTS) as prof:
        fn()
    return prof


@pytest.mark.parametrize("fuse", [False, True])
def test_tiled_probs_is_one_root_with_its_phases(volume, fuse):
    p = Predictor(_StandIn(), device="cpu", fuse_dispatch=fuse)
    prof = profiled(lambda: p.tiled_probs(volume))
    assert tree(prof) == [("dctseg.engine.tiled_probs",
                           ["dctseg.engine.input", "dctseg.engine.forward",
                            "dctseg.engine.stitch"])]


def test_phases_cover_the_root(volume):
    """The root's own time is the stitch-mode check and the batch axis."""
    p = Predictor(_StandIn(), device="cpu")
    prof = profiled(lambda: p.tiled_probs(volume))
    found = spans(prof)
    root = found[0].time_range.elapsed_us()
    phases = sum(e.time_range.elapsed_us() for e in found[1:])
    assert phases >= 0.9 * root


def test_each_call_is_its_own_root(volume):
    p = Predictor(_StandIn(), device="cpu")
    prof = profiled(lambda: [p.tiled_probs(volume) for _ in range(2)])
    assert tree(prof) == [("dctseg.engine.tiled_probs",
                           ["dctseg.engine.input", "dctseg.engine.forward",
                            "dctseg.engine.stitch"])] * 2


def test_batched_tiling_records_only_tiled_probs(volume):
    """V=1 of ``tiled_probs_batch`` is ``tiled_probs``, with its spans; V=2
    runs one forward over both volumes and records none."""
    p = Predictor(_StandIn(), device="cpu")
    prof = profiled(lambda: p.tiled_probs_batch(volume))
    assert tree(prof) == [("dctseg.engine.tiled_probs",
                           ["dctseg.engine.input", "dctseg.engine.forward",
                            "dctseg.engine.stitch"])]
    two = np.concatenate([volume, volume[..., ::-1]])
    assert spans(profiled(lambda: p.tiled_probs_batch(two))) == []


ENGINES = ["tta_probs", "tta_probs_batch", "seg_probs"]


@pytest.fixture(scope="module")
def answers(tiny):
    """Each engine's answer on the tiny model, unprofiled and unfused:
    both cases of an engine compare against it."""
    model, x = tiny
    p = Predictor(model, device="cpu")
    return {method: getattr(p, method)(x) for method in ENGINES}


@pytest.mark.parametrize("method", ENGINES)
@pytest.mark.parametrize("fuse", [False, True])
def test_other_engines_record_no_span(tiny, answers, method, fuse):
    """Only ``tiled_probs``, the path the benchmark reads, records spans;
    the other engines answer as before."""
    model, x = tiny
    p = Predictor(model, device="cpu", fuse_dispatch=fuse)
    want = answers[method]
    prof = profiled(lambda: getattr(p, method)(x))
    assert spans(prof) == []
    torch.testing.assert_close(getattr(p, method)(x), want, rtol=0, atol=0)


def test_microbatched_forward_is_one_span(volume):
    p = Predictor(_StandIn(), device="cpu", microbatch=2)
    prof = profiled(lambda: p.tiled_probs(volume))
    assert tree(prof) == [("dctseg.engine.tiled_probs",
                           ["dctseg.engine.input", "dctseg.engine.forward",
                            "dctseg.engine.stitch"])]


def _train_inputs(batch):
    g = np.random.default_rng(1)
    x = torch.from_numpy(g.normal(size=(batch, 32, 32, 32, 4)).astype(
        np.float32))
    tgt = torch.from_numpy(g.integers(0, 4, (batch, 32, 32, 32)).astype(
        np.uint8))
    edge = torch.from_numpy(g.integers(0, 2, (batch, 32, 32, 32)).astype(
        np.uint8))
    return x, tgt, edge


def test_train_step_is_one_root_with_its_phases():
    cfg = tiny_model_config(fused_norms=False, s2d_fullres=False,
                            s2d_halfres=False, use_pallas_attention=False)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), TrainConfig())
    prof = profiled(lambda: train_step(model, opt, 1e-3, *_train_inputs(2),
                                       grad_accum=2))
    assert tree(prof) == [("dctseg.trainer.step", [
        "dctseg.trainer.optimizer",
        "dctseg.trainer.forward", "dctseg.trainer.backward",
        "dctseg.trainer.forward", "dctseg.trainer.backward",
        "dctseg.trainer.optimizer"])]


def _trainer(tmp_path, prefetch):
    cfg = Config(
        model=tiny_model_config(img_dim=16, top_num=2, fused_norms=False),
        data=DataConfig(synthetic_num_samples=3, input_shape=(24, 24, 20),
                        pad_depth=20, crop_size=(16, 16, 16), num_workers=2),
        train=TrainConfig(end_epoch=1, checkpoint_dir=str(tmp_path),
                          device_prefetch=prefetch))
    return Trainer(cfg, device="cpu")


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_wait_once_a_batch(tmp_path, prefetch):
    """One wait a batch the loop takes, and one for the epoch's end (the
    wait that finds no batch)."""
    tr = _trainer(tmp_path, prefetch)
    with torch.profiler.profile(activities=ACTS) as prof:
        got = list(tr._device_batches())
    assert len(got) == 3
    assert tree(prof) == [("dctseg.trainer.batch_wait", [])] * 4


def test_batch_wait_ends_before_the_step(tmp_path):
    """The wait closes before the batch reaches the loop: a step taken
    between two batches lies outside both."""
    tr = _trainer(tmp_path, 1)
    with torch.profiler.profile(activities=ACTS) as prof:
        for _ in tr._device_batches():
            with torch.profiler.record_function("step"):
                pass
    events = prof.events()
    waits = [e for e in events if e.name == "dctseg.trainer.batch_wait"]
    steps = [e for e in events if e.name == "step"]
    assert len(steps) == 3 and all(s.cpu_parent is None for s in steps)
    assert all(w.time_range.end <= s.time_range.start
               for w, s in zip(waits, steps))


def test_no_profiler_enters_no_record_function(monkeypatch, volume, tmp_path):
    def refuse(*a, **k):
        raise AssertionError("a span entered record_function")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    Predictor(_StandIn(), device="cpu").tiled_probs(volume)
    Predictor(_StandIn(), device="cpu",
              fuse_dispatch=True).tiled_probs(volume)
    cfg = tiny_model_config(fused_norms=False, s2d_fullres=False,
                            s2d_halfres=False, use_pallas_attention=False)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), TrainConfig())
    train_step(model, opt, 1e-3, *_train_inputs(2), grad_accum=2)
    assert len(list(_trainer(tmp_path, 0)._device_batches())) == 3
    assert profiling.span("x") is profiling.span("y")


def test_chrome_trace_holds_the_spans(tmp_path, volume):
    p = Predictor(_StandIn(), device="cpu")
    with profiling.trace(str(tmp_path)):
        p.tiled_probs(volume)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"dctseg.engine.tiled_probs", "dctseg.engine.input",
            "dctseg.engine.forward", "dctseg.engine.stitch"} <= names


# ---- launch counters over CUDA-graph replays ----


class _Graph:
    replays = 0

    def replay(self):
        _Graph.replays += 1


class _Stream:
    def __init__(self, *a, **k):
        pass

    def wait_stream(self, other):
        pass


class _Launching(torch.nn.Module):
    """A stand-in whose forward counts launches as the kernels do: 3 on
    K1's counter, 1 on K2's and on K2's count by kernel."""

    def forward(self, x):
        fusednorm.fused_instance_norm_act.launches += 3
        attention.fused_attention.launches += 1
        attention.fused_attention.kernel_launches["mma"] += 1
        return (x * 2.0 + 1.0,)


@pytest.fixture
def stub_cuda(monkeypatch):
    """torch.cuda's graph, stream and pool calls as no-ops, the counters
    this test moves restored after it."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **k: contextlib.nullcontext())
    monkeypatch.setattr(fusednorm.fused_instance_norm_act, "launches", 0)
    monkeypatch.setattr(attention.fused_attention, "launches", 0)
    monkeypatch.setitem(attention.fused_attention.kernel_launches, "mma", 0)
    _Graph.replays = 0


def _counters():
    return (fusednorm.fused_instance_norm_act.launches,
            attention.fused_attention.launches,
            attention.fused_attention.kernel_launches["mma"])


def test_replays_add_the_captured_launches(stub_cuda, volume):
    p = Predictor(_Launching(), device="cpu", fuse_dispatch=True)
    p.device = torch.device("cuda")    # the graph path, on stubs
    x = torch.from_numpy(volume)
    p._stage(p.crops, x)
    (captured,) = p._graphs.values()
    assert captured.launches == {
        (fusednorm.fused_instance_norm_act, "launches", None): 3,
        (attention.fused_attention, "launches", None): 1,
        (attention.fused_attention, "kernel_launches", "mma"): 1}
    # the warm-up ran and counts; the capture ran nothing and is taken
    # back; the first replay counts
    assert _Graph.replays == 1 and _counters() == (6, 2, 2)
    for n in range(2, 5):
        p._stage(p.crops, x)
        assert _Graph.replays == n and _counters() == (3 + 3 * n, 1 + n,
                                                       1 + n)
    assert len(p._graphs) == 1


def test_launches_since_and_add_launches(monkeypatch):
    monkeypatch.setattr(fusednorm.fused_norm_apply, "launches", 5)
    before = _build.launch_counts()
    fusednorm.fused_norm_apply.launches += 2
    moved = _build.launches_since(before)
    assert moved == {(fusednorm.fused_norm_apply, "launches", None): 2}
    _build.add_launches(moved, 3)
    assert fusednorm.fused_norm_apply.launches == 13
    _build.add_launches(moved, -4)
    assert fusednorm.fused_norm_apply.launches == 5


def test_counted_ops_are_every_launch_counter():
    """``_build.COUNTED`` names every function of ``dctseg_torch.ops`` that
    carries a ``.launches`` counter, and nothing else."""
    found = set()
    for info in pkgutil.iter_modules(dctseg_torch.ops.__path__):
        mod = importlib.import_module(f"dctseg_torch.ops.{info.name}")
        for name, fn in vars(mod).items():
            if (inspect.isfunction(fn) and fn.__module__ == mod.__name__
                    and hasattr(fn, "launches")):
                found.add((info.name, name))
    listed = {(m, n) for m, names in _build.COUNTED.items() for n in names}
    assert found == listed
    for fn in _build.counted_ops():
        assert isinstance(fn.launches, int)


def test_k1_counters_come_from_its_table():
    """K1's launch counters as the benchmark reads them: each name of
    ``_build.COUNTED["fusednorm"]`` and of ``benchmark.trace.COUNTERS``
    is a function of ``ops/fusednorm.py`` with an int ``.launches``, the
    counter of a row of its table; the pre-activation route counts on
    ``fused_instance_norm_act``, whose sum ``k1_roofline.swin`` compares
    with the profile's count of K1's kernels."""
    from benchmark.trace import COUNTERS
    (module, names), _ = COUNTERS["fusednorm"]
    assert module == fusednorm.__name__
    counters = {v.counter for v in fusednorm.VARIANTS.values()}
    for name in {*_build.COUNTED["fusednorm"], *names}:
        fn = getattr(fusednorm, name)
        assert inspect.isfunction(fn) and fn in counters
        assert isinstance(fn.launches, int)
    assert fusednorm.VARIANTS["fused_norm_residual_act"].counter is \
        fusednorm.fused_instance_norm_act
