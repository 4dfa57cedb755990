"""The harness on the CPU at tiny sizes: cells, configurations and
per-layer metrics added as files are found by name, the result line has
the contract's keys, and a run whose timed path is broken underneath comes
out not correct."""

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.run import execute

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 12345      # more than 32 signed bits hold


def tiny_train_config():
    cfg = harness.config("clswiseformer_train")
    cfg["train_driver_args"] += ["--img-dim", "32", "--base-channels", "4",
                                 "--input-shape", "48", "48", "40",
                                 "--num-workers", "2"]
    cfg["model"].update(img_dim=32, base_channels=4, top_num=8)
    cfg["data"].update(input_shape=[48, 48, 40], pad_depth=40,
                       crop_size=[32, 32, 32], num_workers=2)
    return cfg


def tiny_serve_config():
    """Full-size volumes (the engine's crops are 128^3), a narrow model in
    float32."""
    cfg = harness.config("clswiseformer_serve")
    cfg["model"].update(base_channels=1, top_num=8, compute_dtype="float32")
    return cfg


def run_cell(name, cfg, tmp, trace=True, seconds=1.0, **params):
    cell = harness.cell(name)
    cell["params"].update(params)
    ctx = harness.Ctx(name, SEED, seconds, trace, time.perf_counter(),
                      device="cpu", cell_spec=cell, config_spec=cfg)
    ctx.work = Path(tmp)
    return ctx, execute(ctx, harness.spec())


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    return run_cell("train_bf16_b1", tiny_train_config(),
                    tmp_path_factory.mktemp("work"), list_length=16,
                    stretch=2)


def test_result_line_has_the_contract_keys(train_run):
    ctx, line = train_run
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(dev)
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_trace_line_carries_per_layer_metrics(train_run):
    ctx, line = train_run
    _, layer = harness.cell_metrics(harness.spec(), "train_bf16_b1")
    names = {m["name"] for m in layer}
    assert set(line["metrics"]) <= names
    assert "loader_wait_ms.train" in line["metrics"]
    assert line["metrics"]["step_ms.train"]["unit"] == "ms/step"
    assert line["metrics"]["step_ms.train"]["value"] > 0
    assert "mfu.train" in line["metrics"]
    # no device time on the CPU: the convs' share is reported missing
    assert "conv_roofline.train" not in line["metrics"]
    assert any("conv_roofline.train" in n for n in ctx.notes)


def test_end_to_end_line(tmp_path):
    ctx, line = run_cell("train_bf16_b1", tiny_train_config(), tmp_path,
                         trace=False, list_length=16)
    assert set(line["metrics"]) == {"train_memory_peak_gb", "setup_s"}
    assert line["metrics"]["train_memory_peak_gb"]["unit"] == "GB"
    assert line["correct"] is True


def test_added_files_are_found_without_edits(tmp_path, monkeypatch):
    """A new configuration, a new cell of an existing traffic kind and a new
    per-layer metric, each a file of its own plus its BENCHMARK.json entry,
    run without an edit to any file that was there."""
    tree = tmp_path / "tree"
    shutil.copytree(BENCH, tree / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.spec()
    cfg = tiny_train_config()
    (tree / "benchmark/configs/tiny_train.json").write_text(json.dumps(cfg))
    cell = dict(harness.cell("train_bf16_b1"), config="tiny_train")
    cell["params"].update(list_length=16, stretch=2)
    (tree / "benchmark/workloads/tiny_train_b1.json").write_text(
        json.dumps(cell))
    (tree / "benchmark/metrics/steps_seen.tiny.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.items)\n")
    spec["configs"].append({"name": "tiny_train", "source": "x",
                            "file": "benchmark/configs/tiny_train.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny_train_b1", "config": "tiny_train",
                              "traffic": "train_steps", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "steps_seen.tiny", "unit": "steps",
                              "better": "higher", "source": "program_counter",
                              "layer": "trainer and loader",
                              "moves": "train_memory_peak_gb",
                              "workloads": ["tiny_train_b1"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", tree)
    monkeypatch.setattr(harness, "HERE", tree / "benchmark")
    ctx = harness.Ctx("tiny_train_b1", SEED, 1.0, True, time.perf_counter(),
                      device="cpu")
    ctx.work = tmp_path / "work"
    assert ctx.config["model"]["img_dim"] == 32
    line = execute(ctx, harness.spec())
    assert line["metrics"]["steps_seen.tiny"]["value"] == 2.0
    assert line["correct"] is True


def test_train_state_left_unchanged_is_not_correct(tmp_path, monkeypatch):
    """A step that returns its state unchanged: change_gap reads 1."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    ctx, line = run_cell("train_bf16_b1", tiny_train_config(), tmp_path,
                         trace=False, list_length=16)
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_loss_altered_is_not_correct(tmp_path, monkeypatch):
    """The loss altered where it is produced."""
    from dctseg_torch import losses
    from dctseg_torch.train import trainer
    real = losses.total_loss

    def altered(*args, **kw):
        out = real(*args, **kw)
        out["loss"] = out["loss"] * 1.05
        return out
    monkeypatch.setattr(trainer, "total_loss", altered)
    ctx, line = run_cell("train_bf16_b1", tiny_train_config(), tmp_path,
                         trace=False, list_length=16)
    assert line["correct"] is False
    assert line["checks"]["loss_gap"]["value"] > \
        line["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("fault", ["none", "labels_altered", "half_batch"])
def test_serve_answer(tmp_path, monkeypatch, fault):
    """Served labels held to the reference.  Not correct: an answer altered
    where the engine produces it (two classes swapped in one crop's
    region); half of the forward's batch of crops left out, the other half
    standing in for it."""
    from dctseg_torch.infer.engine import Predictor
    if fault == "labels_altered":
        real = Predictor.tiled_probs

        def altered(self, x, *a, **kw):
            p = real(self, x, *a, **kw).clone()
            p[:, :64, :64, :64] = p[:, :64, :64, :64].flip(-1)
            return p
        monkeypatch.setattr(Predictor, "tiled_probs", altered)
    elif fault == "half_batch":
        real_probs = Predictor.model_probs

        def half(self, xs):
            y = real_probs(self, xs[: xs.shape[0] // 2])
            return torch.cat([y, y])
        monkeypatch.setattr(Predictor, "model_probs", half)
    ctx, line = run_cell("serve_bf16_staged", tiny_serve_config(), tmp_path,
                         trace=False, seconds=0.1, pool=2, warmup=1)
    assert line["correct"] is (fault == "none")
    assert set(line["metrics"]) == {"volumes_per_s", "volume_p95_ms",
                                    "setup_s"}
